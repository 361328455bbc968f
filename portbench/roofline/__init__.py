"""The work of each hand-written kernel of the program, one module a
kernel, worked out from the configuration's shapes (and, for a scan, the
rows the probed partitions hold), never from the kernel's own tiling. Each
module's ``least_seconds(...)`` returns the least time the published peaks
allow (:mod:`portbench.bounds`) and which of bytes or operations sets it.
"""

"""The plain reference that decides ``correct``: IVF-PQ search and build
written out in PyTorch (:mod:`.ivfpq`), the arithmetic they run in
(:mod:`.arith`), and the comparison of the program's answers with them
(:mod:`.judge`). Nothing here imports the program, JAX or the JAX package,
and nothing takes a table or array the program derived: the reference
works each one out again from the inputs, or reads the program's output
only to judge it."""

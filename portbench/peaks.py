"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit). A roofline share divides the least time these
allow by the measured time; each run prints the card's power limit beside
them, since a card set below 700 W runs slower under load."""

#: HBM3 bandwidth, bytes a second.
HBM_BYTES_PER_S = 3.35e12
#: Tensor-core TF32, FLOP a second (K-B's and K-C's 3xTF32 products).
TF32_FLOPS = 494.7e12
#: f32 outside the tensor cores, FLOP a second.
FP32_FLOPS = 66.9e12

NAME = "NVIDIA H100 SXM (published)"

"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W power limit): the yardstick of every roofline share.
"""

HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS = 4.95e14  # dense TF32 on the tensor cores: the fastest unit a
                      # float32-input sum of products can use

"""Message-passing ops: plain segment reductions, the fused GGNN kernels
and the whole-model megabatch kernel; the int8 product; attention (plain
and the flash-attention kernel)."""

"""Message-passing ops: plain segment reductions, the fused GGNN kernels
and the whole-model megabatch kernel."""

"""Message-passing ops: plain segment reductions and the fused GGNN kernel."""

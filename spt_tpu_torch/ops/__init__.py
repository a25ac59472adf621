"""Lane ops: vector math, RNG, sampling, intersection, tonemap, kernels."""

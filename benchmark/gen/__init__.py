"""The benchmark's own traffic and weights, made from the seed."""

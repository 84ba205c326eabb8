"""Measurements on the card that are not kernels of the port: yardsticks
that say how fast a layer could be (run each as ``python -m
recmodels_tpu_torch.probes.<name>`` on a machine with an NVIDIA GPU)."""

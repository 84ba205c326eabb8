"""Interaction ops: plain PyTorch versions (``interactions``), CUDA kernels
(``cuda/``) and the dispatch that chooses between them by tensor device."""

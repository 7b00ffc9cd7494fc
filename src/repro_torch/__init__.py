"""PyTorch + CUDA port of the UCCL-Zip reproduction.

Mirrors ``src/repro`` module for module.  Plain tensor code is PyTorch;
the transmit-side encode and the receive-side decode+reduce of the
compressed collectives are CUDA kernels for Hopper (``kernels/csrc``).
Every entry point takes an explicit ``device`` that defaults to ``cuda``.
"""

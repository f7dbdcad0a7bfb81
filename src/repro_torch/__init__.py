"""PyTorch/CUDA port of the ``repro`` SSSP engine (Garg 2018).

The public surface is :mod:`repro_torch.sssp`.  Entry points run on the
CUDA card unless the caller passes ``device="cpu"``; on the CPU every
kernel wrapper takes its plain PyTorch version.
"""

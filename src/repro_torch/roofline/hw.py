"""NVIDIA H100 SXM5 80 GB constants (the dry run's target and the bounds
of ``chip_smoke.py``), under the JAX package's names.

Datasheet figures for the card that ``torch.cuda.get_device_name`` calls
"NVIDIA H100 80GB HBM3", at its 700 W power limit (a card capped lower
runs slower under load):

* dense tensor-core peaks (no 2:4 sparsity) for bf16 and int8, and for
  the TF32 and CUDA-core f32 rates that the kernel bounds use;
* HBM3 at 3.35 TB/s;
* ``ICI_BW_PER_LINK``: NVLink 4's 450 GB/s per direction per GPU, the
  rate of every collective inside one 8-GPU NVSwitch node.  A group wider
  than one node (the 256- and 512-rank production meshes) crosses the
  network instead, at about 50 GB/s per GPU (one NDR 400 Gb/s NIC per
  GPU); one link constant leaves that out, so the collective term is a
  lower bound for such a group;
* ``HBM_PER_CHIP``: the card's ``total_memory`` as PyTorch reports it;
* ``VMEM_PER_CHIP``: the on-chip scratch the kernels stage tiles in,
  228 KiB of shared memory per SM x 132 SMs.
"""

PEAK_FLOPS_BF16 = 989e12       # per card, dense
PEAK_FLOPS_INT8 = 1979e12      # per card, dense
PEAK_FLOPS_TF32 = 495e12       # per card, dense
PEAK_FLOPS_F32 = 67e12         # per card, CUDA cores
HBM_BW = 3.35e12               # bytes/s per card
ICI_BW_PER_LINK = 450e9        # bytes/s per GPU per direction (NVLink 4)
HBM_PER_CHIP = 85_017_493_504  # bytes (total_memory, chip run)
VMEM_PER_CHIP = 228 * 2**10 * 132   # bytes of shared memory

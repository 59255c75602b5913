"""Data parallelism over one process per GPU (counterpart of the data axis
of ``lasr_tpu/parallel/mesh.py``); see ``dist.py``."""

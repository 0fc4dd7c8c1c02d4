"""Data parallelism over processes: one rank a device, over
``torch.distributed`` (port of ``nextbestpath_tpu/parallel/``)."""

"""kernel_load_s: the wall clock of loading the port's CUDA kernels in
set-up (``repro_torch.kernels._build.build_seconds``), from the checkout's
build cache after the first run there."""


def read(record):
    return record.get("kernel_load_s")

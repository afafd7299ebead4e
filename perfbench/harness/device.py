"""The few device calls the drivers make, no-ops off the card (the
harness's tests run on the CPU)."""


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def max_memory(dev) -> int:
    import torch
    return int(torch.cuda.max_memory_allocated(dev)) \
        if dev.type == "cuda" else 0


def reset_peak(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def empty_cache(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.empty_cache()

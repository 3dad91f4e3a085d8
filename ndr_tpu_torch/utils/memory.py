"""Parameter and program memory sizes (counterpart of
``ndr_tpu/utils/memory.py``; the reference's SizeEstimator).

The JAX package reads a compiled executable's memory analysis. PyTorch
runs eagerly, so :func:`estimate_size` runs the function once on the card
and reads the allocator's statistics around it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator

import torch


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def param_bytes(params: Any) -> int:
    """Total bytes of a module's parameters (its buffers excluded, like the
    JAX package's frozen Fourier matrix), or of the tensors in a nested
    dict / list / tuple."""
    return int(sum(t.numel() * t.element_size() for t in _tensors(params)))


def estimate_size(fn: Callable, *args, **kwargs) -> Dict[str, float]:
    """Run ``fn(*args, **kwargs)`` once on the card of its tensor arguments
    and report its memory in MB: ``argument_mb`` (the tensor arguments),
    ``output_mb`` (the tensor outputs), ``temp_mb`` (the allocator's peak
    during the call above what was allocated before it, less the outputs)
    and ``total_mb``. Returns ``{}`` when no argument lies on a card (the
    CPU keeps no allocator statistics), as the JAX package does on a
    backend without memory analysis."""
    tensors = list(_tensors((args, kwargs)))
    cuda = [t for t in tensors if t.is_cuda]
    if not cuda:
        return {}
    dev = cuda[0].device
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn(*args, **kwargs)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    mb = 1.0 / 2**20
    out_bytes = sum(t.numel() * t.element_size() for t in _tensors(out))
    res = {
        "argument_mb": sum(t.numel() * t.element_size() for t in tensors) * mb,
        "output_mb": out_bytes * mb,
        "temp_mb": max(peak - before - out_bytes, 0) * mb,
    }
    res["total_mb"] = sum(res.values())
    return res

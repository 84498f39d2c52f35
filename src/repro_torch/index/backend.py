"""Scan-backend registry: which stage-1/stage-2 implementation an index
uses, and the capability flags the index layer resolves against (the
same names as ``repro/index/backend.py``).

  * ``cuda``  — the hand-written Hopper kernels. Declares
                ``streaming_topl`` (stage 1 never builds the (Q, N) score
                matrix) and ``fused_topl`` (that stage is one fused scan
                + top-L kernel).
  * ``torch`` — the plain PyTorch versions: the chunked stream
                (``streaming_topl``) and the chunked table rerank. Valid
                only for ``device="cpu"``.

``"auto"`` resolves by the index's device: ``cuda`` for a CUDA device,
which raises when there is no card (the port never drops to the CPU on
its own), ``torch`` for an explicit ``device="cpu"``. The reference's
other flags (``dispatch_topl``, ``tuned``, ``quantized_lut``) arrive
with the slices that port them. ``fused_rerank`` is not declared: the
reference uses it to pick the table rerank's impl, and here
``ops.rerank_gather_dist`` picks it by the tensors' device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ScanBackend:
    name: str
    device_type: str                    # the device type it runs on
    capabilities: frozenset = frozenset()


_REGISTRY: dict[str, ScanBackend] = {
    b.name: b for b in (
        ScanBackend("cuda", "cuda", frozenset({"streaming_topl",
                                               "fused_topl"})),
        ScanBackend("torch", "cpu", frozenset({"streaming_topl"})),
    )
}


def available_scan_backends() -> list[str]:
    return sorted(_REGISTRY)


def backend_capabilities(name: str) -> frozenset:
    """Declared capability flags of a registered backend."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown scan backend {name!r}; registered: "
                         f"{available_scan_backends()}")
    return _REGISTRY[name].capabilities


def backend_supports(name: str, capability: str) -> bool:
    """True iff ``name`` is registered and declares ``capability``."""
    return name in _REGISTRY and capability in _REGISTRY[name].capabilities


def resolve_scan_backend(name: str | None = "auto",
                         device: str | torch.device = "cuda") -> str:
    """Map a backend request on ``device`` to a registered backend name.
    Raises RuntimeError for a CUDA device without a card, ValueError for
    an unknown name or one that does not run on ``device``."""
    device = resolve_device(device)
    if name is None or name == "auto":
        name = "cuda" if device.type == "cuda" else "torch"
    if name not in _REGISTRY:
        raise ValueError(f"unknown scan backend {name!r}; registered: "
                         f"{available_scan_backends()} (or 'auto')")
    if _REGISTRY[name].device_type != device.type:
        raise ValueError(f"scan backend {name!r} runs on "
                         f"{_REGISTRY[name].device_type}, not on {device}")
    return name

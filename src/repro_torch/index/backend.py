"""Scan-backend registry: which stage-1/stage-2 implementation an index
uses, and the capability flags the index layer resolves against (the
same names as ``repro/index/backend.py``).

  * ``cuda``   — the hand-written Hopper kernels. Declares
                 ``streaming_topl`` (stage 1 never builds the (Q, N)
                 score matrix), ``fused_topl`` (that stage is one fused
                 scan + top-L kernel) and ``quantized_lut`` (the scan
                 takes f16 and i8 tables: ``lut_dtype``/``overfetch``).
  * ``torch``  — the plain PyTorch versions: the chunked stream
                 (``streaming_topl``, ``quantized_lut``) and the chunked
                 table rerank. Valid only for ``device="cpu"``.
  * ``onehot`` — the reference's name for the materialized stage 1
                 (``MaterializedTopL``): the full (Q, N) score matrix,
                 then a stable top-L. No ``streaming_topl`` and no
                 ``quantized_lut``; it runs on either device and is
                 only ever pinned by name (``Scan(onehot)``), never
                 picked by ``"auto"``. The reference builds that matrix
                 with an XLA one-hot einsum; on the card the matrix is
                 exactly the function of its ``adc_scan_batch_pallas``,
                 so here it comes from that kernel's port
                 (``ops.adc_scan_batch``), and from ``ref.adc_scan_batch_ref``
                 on the CPU.

``"auto"`` resolves by the index's device: ``cuda`` for a CUDA device,
which raises when there is no card (the port never drops to the CPU on
its own), ``torch`` for an explicit ``device="cpu"``. The reference's
other flags (``dispatch_topl``, ``tuned``) arrive with the slices that
port them. ``fused_rerank`` is not declared: the reference uses it to
pick the table rerank's impl, and here ``ops.rerank_gather_dist`` picks
it by the tensors' device.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ScanBackend:
    name: str
    device_types: frozenset             # the device types it runs on
    capabilities: frozenset = frozenset()


_REGISTRY: dict[str, ScanBackend] = {
    b.name: b for b in (
        ScanBackend("cuda", frozenset({"cuda"}),
                    frozenset({"streaming_topl", "fused_topl",
                               "quantized_lut"})),
        ScanBackend("torch", frozenset({"cpu"}),
                    frozenset({"streaming_topl", "quantized_lut"})),
        ScanBackend("onehot", frozenset({"cuda", "cpu"})),
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
    if device.type not in _REGISTRY[name].device_types:
        raise ValueError(f"scan backend {name!r} runs on "
                         f"{' or '.join(sorted(_REGISTRY[name].device_types))}"
                         f", not on {device}")
    return name

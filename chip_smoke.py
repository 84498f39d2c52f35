#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA Hopper card.

    python3 chip_smoke.py            # from the repository root, one card

Phases, each printed as it runs; any failure exits nonzero:

  1. environment: the card (nvidia-smi name and power limit), torch and
     CUDA versions, the TF32 flags (both must be False);
  2. build: every CUDA kernel of the path, from ``src/repro_torch/kernels/
     csrc``, with nvcc's register report;
  3. each kernel against its plain PyTorch version on the card, at the
     main path's shapes: ``unq_encode`` at B=8192 on DEEP_8B (codes equal
     outside near-ties), ``adc_scan_topl`` at N=1,000,000, M=8, K=256,
     L=500 on real LUTs, on tie-heavy integer LUTs, and with a (Q, N)
     filter at an N that is no multiple of the tile (bit-identical);
  4. the main path: ``index_factory("UNQ8x256,Rerank500", dim=96)`` ->
     ``UNQIndex.from_trained`` on DEEP_8B weights drawn from a numpy seed
     -> ``add`` of 1,000,000 synthetic Deep1M-like descriptors in batches
     of several ENCODE_BUCKETS sizes -> ``search`` of 1,000 queries at
     k=100, with phase times, peak memory, each kernel's launch count
     (both must be > 0), a save/load round trip (identical results), and
     checks of the output against the plain versions;
  5. one JSON line of per-kernel times (CUDA events) beside their bounds;
  6. the last line: {"ok": true, "device": {...}}.

Without a card, or run outside the repository, it exits nonzero before
printing a result. It writes only under ``build/`` in the checkout.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# the main path's sizes: Deep1M's base set, 1,000 queries, k=100
N_BASE, N_QUERY, K = 1_000_000, 1_000, 100
# published peaks of one H100 SXM (NVIDIA data sheet): fp32 outside the
# tensor cores, counting an FMA as two operations; a lone f32 add runs at
# half that (132 SMs x 128 lanes x 1.98 GHz); HBM3 bandwidth
FP32_FLOPS = 67e12
FP32_ADDS = FP32_FLOPS / 2
# conflict-free shared-memory reads: 32 four-byte words per SM per clock
SMEM_WORDS_PER_S = 132 * 32 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
ENCODE_GAP_RTOL = 1e-5


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls, by
    CUDA events, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(ops: float, rate: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = ops / rate, nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, \
        ("operations" if t_ops >= t_bytes else "bytes")


class Timer:
    """Host clock around work that ends in ``torch.cuda.synchronize()``."""

    def __init__(self, torch):
        self.torch = torch
        self.ms: dict[str, float] = {}

    def __call__(self, name, fn):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        self.torch.cuda.synchronize()
        self.ms[name] = (time.perf_counter() - t0) * 1e3
        return out


def encode_parity(torch, ops_mod, unq_encode, heads, books):
    """Kernel vs plain ``unq_encode``: codes must be equal wherever the
    top-2 scores (float64) are apart by more than ENCODE_GAP_RTOL of the
    row's largest |score|. Returns (mismatches, near_ties, max_abs_err),
    the error being the float64 score lost by the kernel's choice."""
    got = ops_mod.unq_encode(heads, books)
    want = unq_encode.unq_encode_plain(heads, books)
    s = torch.einsum("bmd,mkd->bmk", heads.double(), books.double())
    top2 = torch.topk(s, 2, dim=-1).values
    near = (top2[..., 0] - top2[..., 1]) <= \
        ENCODE_GAP_RTOL * s.abs().amax(dim=-1)
    diff = got != want
    if (diff & ~near).any():
        raise AssertionError(
            f"unq_encode: {int((diff & ~near).sum())} codes differ from the "
            "plain version outside near-ties")
    lost = (s.gather(-1, want.long()[..., None])
            - s.gather(-1, got.long()[..., None])).abs()
    return int(diff.sum()), int(near.sum()), float(lost.max())


def scan_parity(torch, topl_scan, ops_mod, codes, luts, bias, qbias, topl,
                name, need_inf=False):
    """Kernel vs plain ``adc_scan_topl``: bit-identical (score, id);
    ``need_inf`` requires filtered (+inf) entries in the result."""
    got = ops_mod.adc_scan_topl(codes, luts, topl=topl, bias=bias,
                                qbias=qbias)
    want = topl_scan.adc_scan_topl_stream(codes, luts, bias, qbias,
                                          topl=topl, n_valid=codes.shape[0])
    torch.cuda.synchronize()
    same_ids = torch.equal(got[1], want[1])
    same_scores = torch.equal(got[0], want[0])
    err = float((got[0] - want[0]).nan_to_num(0.0, 0.0, 0.0).abs().max())
    n_inf = int(torch.isinf(got[0]).sum())
    log(f"  adc_scan_topl [{name}]: Q={luts.shape[0]} N={codes.shape[0]} "
        f"L={topl} qbias={'yes' if qbias is not None else 'no'}: "
        f"ids equal={same_ids} scores equal={same_scores} "
        f"max_abs_err={err} (+inf entries: {n_inf})")
    if not (same_ids and same_scores):
        raise AssertionError(f"adc_scan_topl [{name}] differs from the "
                             "plain version")
    if need_inf and n_inf == 0:
        raise AssertionError(f"adc_scan_topl [{name}]: no filtered entry "
                             "reached the result")
    return err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401 — pins the fp32 matmul flags
    from repro_torch.configs.unq_paper import DEEP_8B
    from repro_torch.core import unq
    from repro_torch.data import descriptors
    from repro_torch.index import (Index, UNQIndex, candidate_generator_for,
                                   index_factory)
    from repro_torch.kernels import build, ops, topl_scan, unq_encode

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = card_line()

    # -- 1. environment --------------------------------------------------------
    log("== 1. environment")
    log(f"card: {card}")
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}, sm_{''.join(map(str, torch.cuda.get_device_capability(0)))}")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    log(f"allow_tf32: matmul={tf32[0]} cudnn={tf32[1]}")
    if any(tf32):
        raise AssertionError("TF32 must be off (unq_encode is an argmax)")

    # -- 2. build ----------------------------------------------------------------
    log("== 2. build")
    t0 = time.perf_counter()
    built = build.build()
    log(f"built {len(built)} libraries from {build.CSRC.relative_to(ROOT)} "
        f"in {time.perf_counter() - t0:.2f} s (one nvcc per source, "
        "in parallel)")
    for res in built.values():
        regs = [ln.strip() for ln in res.log.splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"  {res.name}.cu: {res.seconds:.2f} s; " + " | ".join(regs))

    # -- data and weights (set-up) -------------------------------------------------
    cfg = DEEP_8B
    t0 = time.perf_counter()
    ds = descriptors.make_synthetic_dataset(
        "deep", n_train=10_000, n_base=N_BASE, n_query=N_QUERY,
        seed=args.seed, compute_gt=False)
    params, state = unq.numpy_params(cfg, args.seed, bn_stats=True,
                                     center=ds.train)
    model = unq.unq_from_jax(params, state, cfg)
    log(f"set-up: {N_BASE} x {cfg.dim} base, {N_QUERY} queries, "
        f"DEEP_8B weights from seed {args.seed} in "
        f"{time.perf_counter() - t0:.1f} s")

    # -- 3. kernels vs plain versions ------------------------------------------------
    log("== 3. kernels vs their plain versions, on the card")
    gpu_model = unq.unq_from_jax(params, state, cfg).to(dev) \
        .requires_grad_(False)
    base_dev = torch.as_tensor(ds.base, device=dev)
    queries_dev = torch.as_tensor(ds.queries, device=dev)
    with torch.no_grad():
        heads = gpu_model.encode_heads(base_dev[:8192]).contiguous()
        luts_all = -gpu_model.head_logits(gpu_model.encode_heads(queries_dev))
    books = gpu_model.codebooks.detach().contiguous()
    mism, near, enc_err = encode_parity(torch, ops, unq_encode, heads, books)
    log(f"  unq_encode: B=8192 M={cfg.num_codebooks} K={cfg.codebook_size} "
        f"d_c={cfg.code_dim}: {mism} codes differ from the plain version, "
        f"all within near-ties (top-2 gap <= {ENCODE_GAP_RTOL} x max|score|; "
        f"{near} near-ties of {8192 * cfg.num_codebooks}); "
        f"max_abs_err={enc_err}")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    n1 = N_BASE
    sub = 64
    codes_rand = torch.randint(0, 256, (n1, cfg.num_codebooks),
                               dtype=torch.uint8, device=dev, generator=gen)
    zeros = torch.zeros(n1, device=dev)
    scan_err = scan_parity(torch, topl_scan, ops, codes_rand,
                           luts_all[:sub].contiguous(), zeros, None, 500,
                           "real LUTs")
    int_luts = torch.randint(-2, 3, (sub, cfg.num_codebooks, 256),
                             device=dev, generator=gen).float()
    scan_err = max(scan_err, scan_parity(
        torch, topl_scan, ops, codes_rand, int_luts, zeros, None, 500,
        "tie-heavy integer LUTs"))
    n_rag = n1 - 17                    # no multiple of the 256-row tile
    # ~400 kept points per query < L: +inf (filtered) entries reach the
    # result and must keep their real ids in ascending order
    keep = torch.rand((sub, n_rag), device=dev, generator=gen) < 4e-4
    qbias = torch.where(keep, 0.0, float("inf"))
    rbias = torch.randint(-1, 2, (n_rag,), device=dev,
                          generator=gen).float()
    scan_err = max(scan_err, scan_parity(
        torch, topl_scan, ops, codes_rand[:n_rag].contiguous(), int_luts,
        rbias, qbias, 500, "filter qbias, ragged N", need_inf=True))
    del codes_rand, qbias, keep

    # -- 4. the main path --------------------------------------------------------------
    log("== 4. main path: index_factory -> from_trained -> add -> search")
    spec = "UNQ8x256,Rerank500"
    index = index_factory(spec, dim=cfg.dim)
    if not (isinstance(index, UNQIndex) and index.cfg == cfg):
        raise AssertionError(f"{spec} did not build a DEEP_8B UNQIndex")
    index = UNQIndex.from_trained(model, rerank=index.rerank,
                                  device=index.device)
    batches = [100, 900, 3_000, 7_000]
    rest = N_BASE - sum(batches)
    batches += [250_000] * (rest // 250_000) + [rest % 250_000]
    batches = [b for b in batches if b > 0]
    buckets = sorted({Index._encode_bucket(b) for b in batches})
    torch.cuda.reset_peak_memory_stats()
    timer = Timer(torch)

    def counted(name, fn):
        """Run ``fn`` under the timer with every launch count set to 0
        just before it; return its result and the counts just after."""
        unq_encode.unq_encode_cuda.launches = 0
        topl_scan.adc_scan_topl_cuda.launches = 0
        out = timer(name, fn)
        return out, {"unq_encode": unq_encode.unq_encode_cuda.launches,
                     "adc_scan_topl": topl_scan.adc_scan_topl_cuda.launches}

    def add_all():
        lo = 0
        for b in batches:
            index.add(base_dev[lo:lo + b])
            lo += b

    _, launches_add = counted("encode (add)", add_all)
    k = K
    (D_cold, I_cold), launches_search = counted(
        "search, first call (cold)", lambda: index.search(queries_dev, k))
    launches = {name: launches_add[name] + launches_search[name]
                for name in launches_add}
    luts = timer("LUT build", lambda: index._build_luts(queries_dev))
    stage1 = candidate_generator_for(index.device)
    d2, cand = timer("stage 1", lambda: stage1.topl(
        index.codes, luts, None, topl=index.rerank))
    D_stages, I_stages = timer(
        "stage 2", lambda: index._rerank_topk(queries_dev, cand, k))
    D, I = timer("search total", lambda: index.search(queries_dev, k))
    peak = torch.cuda.max_memory_allocated()
    for name, ms in timer.ms.items():
        log(f"  {name}: {ms:.3f} ms")
    log(f"  added {index.ntotal} vectors in {len(batches)} batches "
        f"{batches} (encode buckets {buckets}); searched "
        f"{N_QUERY} queries at k={k}, L={index.rerank}")
    log(f"  max_memory_allocated: {peak} B ({peak / 2**30:.2f} GiB)")
    log(f"  kernel launches (adc_scan_topl: scan + merge kernel per call) "
        f"in add: {launches_add}; in one search: {launches_search}")
    if launches_add["unq_encode"] <= 0 or \
            launches_search["adc_scan_topl"] <= 0:
        raise AssertionError(f"a kernel was not launched on the main path: "
                             f"add {launches_add}, search {launches_search}")

    # checks of what came out
    q = N_QUERY
    if D.shape != (q, k) or I.shape != (q, k):
        raise AssertionError(f"search returned {D.shape}, {I.shape}")
    if not torch.isfinite(D).all() or (D < 0).any():
        raise AssertionError("search distances must be finite and >= 0")
    if (D[:, 1:] < D[:, :-1]).any():
        raise AssertionError("search distances must ascend")
    if (I < 0).any() or (I >= index.ntotal).any():
        raise AssertionError("search ids out of range")
    if not all(torch.equal(a, b) for a, b in
               ((D, D_stages), (I, I_stages), (D, D_cold), (I, I_cold))):
        raise AssertionError("search() differs between calls or from its "
                             "stages run apart")
    sq = 16
    want1 = topl_scan.adc_scan_topl_stream(
        index.codes, luts[:sq], torch.zeros(index.ntotal, device=dev),
        topl=index.rerank, n_valid=index.ntotal)
    if not (torch.equal(d2[:sq], want1[0]) and torch.equal(cand[:sq],
                                                           want1[1])):
        raise AssertionError("stage 1 of the main path differs from the "
                             "plain stream")
    with torch.no_grad():
        recon = index.model.decode_codes(index.codes[I[:sq].reshape(-1)
                                                     .long()])
        d1 = ((recon.reshape(sq, k, -1) - queries_dev[:sq, None, :]) ** 2) \
            .sum(-1)
    d1_err = float((d1 - D[:sq]).abs().max())
    if not torch.allclose(d1, D[:sq], rtol=1e-5, atol=1e-5):
        raise AssertionError(f"d1 of the returned ids differs: {d1_err}")
    log(f"  checks: shapes, finite ascending D, ids in range, stage 1 "
        f"bit-identical to the plain stream on {sq} queries, D equal to "
        f"directly decoded d1 (max abs diff {d1_err})")

    # a small input against the CPU (the plain versions end to end)
    small_n, small_q = 20_000, 32
    cpu_index = UNQIndex.from_trained(
        unq.unq_from_jax(params, state, cfg), rerank=index.rerank,
        device="cpu").add(ds.base[:small_n])
    small_codes_gpu = index.codes[:small_n].cpu()
    same_codes = float((small_codes_gpu == cpu_index.codes).float().mean())
    gpu_small = UNQIndex.from_trained(
        unq.unq_from_jax(params, state, cfg), codes=cpu_index.codes,
        rerank=index.rerank, device=dev)
    Dc, Ic = cpu_index.search(ds.queries[:small_q], k)
    Dg, Ig = (x.cpu() for x in gpu_small.search(queries_dev[:small_q], k))
    gap = (Dc[:, 1:] - Dc[:, :-1]).abs() > 1e-4
    apart = torch.ones_like(Dc, dtype=torch.bool)
    apart[:, 1:] &= gap
    apart[:, :-1] &= gap
    small_err = float((Dg - Dc).abs().max())
    if not (torch.allclose(Dg, Dc, rtol=1e-5, atol=1e-5)
            and torch.equal(Ig[apart], Ic[apart])):
        raise AssertionError(f"card vs CPU on the small input: max |dD| "
                             f"{small_err}")
    log(f"  small input vs the CPU path (N={small_n}, Q={small_q}): codes "
        f"equal on {same_codes:.6f} of entries, D max abs diff {small_err}, "
        f"ids equal on all {int(apart.sum())} positions apart from ties")

    save_dir = ROOT / "build" / "chip_smoke_index"
    if save_dir.exists():
        shutil.rmtree(save_dir)
    index.save(save_dir)
    loaded = Index.load(save_dir)
    D2, I2 = loaded.search(queries_dev, k)
    same = torch.equal(D2, D) and torch.equal(I2, I)
    shutil.rmtree(save_dir)
    log(f"  save/load round trip: results identical={same}")
    if not same:
        raise AssertionError("save/load changed the search results")

    # -- 5. kernel timings -----------------------------------------------------------------
    log("== 5. kernels at the main path's shapes (CUDA events)")
    m_, k_, dc = cfg.num_codebooks, cfg.codebook_size, cfg.code_dim
    b = heads.shape[0]
    enc_ms = cuda_ms(torch, lambda: ops.unq_encode(heads, books), reps=50)
    enc_plain = cuda_ms(torch, lambda: unq_encode.unq_encode_plain(
        heads, books), reps=20)
    enc_lib = cuda_ms(torch, lambda: torch.bmm(
        heads.transpose(0, 1), books.transpose(1, 2)).argmax(-1), reps=20)
    enc_bound = bound_ms(2.0 * b * m_ * k_ * dc, FP32_FLOPS,
                         4.0 * (b * m_ * dc + m_ * k_ * dc + b * m_))
    n = index.ntotal
    L = index.rerank
    luts_c = luts.contiguous()
    bias0 = torch.zeros(n, device=dev)
    scan_ms = cuda_ms(torch, lambda: ops.adc_scan_topl(
        index.codes, luts_c, topl=L, bias=bias0), reps=10)
    scan_plain = cuda_ms(torch, lambda: topl_scan.adc_scan_topl_stream(
        index.codes, luts_c, bias0, topl=L, n_valid=n), reps=2, warmup=1)
    # ms covers both launches (scan, then merge of the slices' lists)
    scan_bound = bound_ms(float(q) * n * m_, FP32_ADDS,
                          n * m_ + 4.0 * n + 4.0 * q * m_ * k_ + 8.0 * q * L)
    kernels = [
        {"name": "unq_encode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/unq_encode.cu",
         "replaces": "src/repro/kernels/unq_encode.py:49",
         "launches": launches["unq_encode"], "max_abs_err": enc_err,
         "ms": enc_ms, "plain_ms": enc_plain, "bound_ms": enc_bound[0],
         "bound_by": enc_bound[1], "library_ms": enc_lib},
        {"name": "adc_scan_topl", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/topl_scan.cu",
         "replaces": "src/repro/kernels/topl_scan.py:157",
         "launches": launches["adc_scan_topl"], "max_abs_err": scan_err,
         "ms": scan_ms, "plain_ms": scan_plain, "bound_ms": scan_bound[0],
         "bound_by": scan_bound[1], "library_ms": None},
    ]
    shapes = {"unq_encode": f"B={b} M={m_} K={k_} d_c={dc}",
              "adc_scan_topl": f"Q={q} N={n} M={m_} K={k_} L={L}"}
    for kr in kernels:
        lib = "none" if kr["library_ms"] is None else \
            f"{kr['library_ms']:.4f}"
        log(f"  {kr['name']} ({shapes[kr['name']]}) on {card}: "
            f"{kr['ms']:.4f} ms, bound {kr['bound_ms']:.4f} ms "
            f"({kr['bound_by']}), plain {kr['plain_ms']:.4f} ms, "
            f"library {lib} ms, launches {kr['launches']}, parity ok")
    log(f"  adc_scan_topl: a second ceiling, its Q*N*M LUT gathers from "
        f"shared memory at no bank conflict, is "
        f"{q * n * m_ / SMEM_WORDS_PER_S * 1e3:.4f} ms; ms is the scan and "
        f"merge launches together")
    log(f"total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

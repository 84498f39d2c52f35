#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA Hopper card.

    python3 chip_smoke.py            # from the repository root, one card

Phases, each printed as it runs; any failure exits nonzero:

  1. environment: the card (nvidia-smi name and power limit), torch and
     CUDA versions, the TF32 flags (both must be False);
  2. build: every CUDA kernel, from ``src/repro_torch/kernels/csrc``,
     with nvcc's register report;
  3. each kernel against its plain PyTorch version on the card, at the
     main paths' shapes: ``unq_encode`` at B=8192 on DEEP_8B (codes equal
     outside near-ties), ``adc_scan_topl`` at N=1,000,000, M=8, K=256,
     L=500 on real LUTs, on tie-heavy integer LUTs, and with a (Q, N)
     filter at an N that is no multiple of the tile, its f16 and i8
     faces at the same N with a pool of 1,000 (L=500, overfetch 2) on
     real LUTs and under the filter, its f32 face at L=1,025, 1,500 and
     4,096 and at M=32, K=256, L=500 on N=100,000 (all bit-identical),
     ``quantize_luts`` on the card against the CPU (scales and codes bit
     for bit), ``adc_scan`` at N=1M and ``adc_scan_batch`` at Q=1,000,
     N=1M (bit-identical), ``rerank_gather_dist`` at Q=1000, L=500, M=8,
     K=256, D=96 on a real OPQ table (within RERANK_TOL) and on an
     integer-valued table (bit-identical);
  4. the UNQ path: ``index_factory("UNQ8x256,Rerank500", dim=96)`` ->
     ``UNQIndex.from_trained`` on DEEP_8B weights drawn from a numpy seed
     -> ``add`` of 1,000,000 synthetic Deep1M-like descriptors in batches
     of several ENCODE_BUCKETS sizes -> ``search`` of 1,000 queries at
     k=100, with phase times, peak memory, each kernel's launch count
     (``unq_encode`` in add and ``adc_scan_topl`` in search must be
     > 0), a save/load round trip (identical results), checks of the
     output against the plain versions, and a float16 search at
     overfetch 2 with its times and the pool's recall against the exact
     stage 1;
  5. the OPQ path: ``index_factory("OPQ8x256,Rerank500", dim=96)`` ->
     ``train`` on 100,000 vectors with the reference's default iteration
     counts -> ``add`` of the same 1,000,000 descriptors -> ``search``
     of the same 1,000 queries at k=100, with phase times, peak memory,
     R@1/R@10/R@100 against the exact neighbours, launch counts per
     phase (``adc_scan_topl`` and ``rerank_gather_dist`` must be > 0 in
     search), a save/load round trip, stage 2 and the final ids against
     the plain stage 2, and a filtered search that underfills the pool;
     then the quantized searches (``lut_dtype="float16"`` at overfetch
     2, ``"int8"`` at overfetch 2 and 3), each with its stage-1 and
     warm search times, recall@L of its stage 1 against the exact one,
     R@1/10/100 and its results against the plain quantized path; the
     same index under ``Scan(onehot)`` (the materialized (Q, N) stage 1
     on ``adc_scan_batch``), equal to the streaming search bit for bit,
     with its peak memory; and ``search_pq`` (one ``adc_scan`` per
     query) over the OPQ codes with its recall;
  6. one JSON line of per-kernel times (CUDA events) beside their bounds;
  7. the last line: {"ok": true, "device": {...}}.

Without a card, or run outside the repository, it exits nonzero before
printing a result. In the checkout it writes the kernel libraries under
``src/repro_torch/kernels/_build/`` and, for the round trips, saved
indexes under ``build/``, which it removes again.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import re
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# the main paths' sizes: Deep1M's base set, 1,000 queries, k=100; the
# OPQ path trains on N_TRAIN vectors, a fifth of the paper's 500,000
N_BASE, N_QUERY, K = 1_000_000, 1_000, 100
N_TRAIN, PAPER_N_TRAIN = 100_000, 500_000
# published peaks of one H100 SXM (NVIDIA data sheet): fp32 outside the
# tensor cores, counting an FMA as two operations; a lone f32 add runs at
# half that (132 SMs x 128 lanes x 1.98 GHz); HBM3 bandwidth
FP32_FLOPS = 67e12
FP32_ADDS = FP32_FLOPS / 2
# conflict-free shared-memory reads: 32 four-byte words per SM per clock
SMEM_WORDS_PER_S = 132 * 32 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
ENCODE_GAP_RTOL = 1e-5
# d1 of the rerank kernel against the plain version on real tables: the
# sum over D runs in another order (96 f32 terms, values ~1)
RERANK_TOL = {"rtol": 1e-5, "atol": 1e-5}


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


def ptxas_report(nvcc_log: str) -> list[str]:
    """One line per kernel of ``nvcc -Xptxas -v`` output: its name
    (demangled by ``c++filt`` where the machine has it), registers and
    spills."""
    entries, name, spill = [], "?", ""
    for ln in nvcc_log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", ln)
        if m:
            name = m.group(1)
        elif "spill" in ln:
            spill = ln.split(",", 1)[-1].strip()
        elif "registers" in ln:
            entries.append((name, f"{ln.split(':', 1)[-1].strip()}; {spill}"))
    names = [n for n, _ in entries]
    if names and shutil.which("c++filt"):
        names = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    names = [n.replace("(anonymous namespace)::", "").removeprefix("void ")
             .split("(")[0] for n in names]
    return [f"{n}: {r}" for n, (_, r) in zip(names, entries)]


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


def scan_parity(torch, topl_scan, ops_mod, lut_quant, codes, luts, bias,
                qbias, topl, name, need_inf=False, lut_dtype="float32"):
    """Kernel vs plain ``adc_scan_topl`` at one table type (the tables
    quantized once, both sides given the same ones): bit-identical
    (score, id); ``need_inf`` requires filtered (+inf) entries in the
    result."""
    qluts, scale = lut_quant.quantize_luts(luts, lut_dtype)
    got = ops_mod._scan_topl_run(codes, qluts, scale, bias, qbias, topl=topl)
    want = topl_scan.adc_scan_topl_stream(codes, qluts, bias, qbias, scale,
                                          topl=topl, n_valid=codes.shape[0])
    torch.cuda.synchronize()
    same_ids = torch.equal(got[1], want[1])
    same_scores = torch.equal(got[0], want[0])
    err = float((got[0] - want[0]).nan_to_num(0.0, 0.0, 0.0).abs().max())
    n_inf = int(torch.isinf(got[0]).sum())
    bq = topl_scan.block_q(luts.shape[1], luts.shape[2], topl, lut_dtype)
    log(f"  adc_scan_topl {lut_dtype} [{name}]: Q={luts.shape[0]} "
        f"N={codes.shape[0]} M={luts.shape[1]} L={topl} (BQ={bq}) "
        f"qbias={'yes' if qbias is not None else 'no'}: "
        f"ids equal={same_ids} scores equal={same_scores} "
        f"max_abs_err={err} (+inf entries: {n_inf})")
    if not (same_ids and same_scores):
        raise AssertionError(f"adc_scan_topl {lut_dtype} [{name}] differs "
                             "from the plain version")
    if need_inf and n_inf == 0:
        raise AssertionError(f"adc_scan_topl [{name}]: no filtered entry "
                             "reached the result")
    return err


def pool_recall(torch, got, want) -> float:
    """Mean share of each query's ``want`` ids found among its ``got``
    ids (recall@L of one candidate pool against another)."""
    hits = [torch.isin(want[i], got[i]).float().mean()
            for i in range(want.shape[0])]
    return float(torch.stack(hits).mean())


def rerank_parity(torch, ops_mod, rerank_dist, cand, queries, table, name,
                  exact):
    """Kernel vs plain ``rerank_gather_dist``: bit-identical if ``exact``,
    else within RERANK_TOL. Returns (max_abs_err, max_rel_err)."""
    got = ops_mod.rerank_gather_dist(cand, queries, table)
    want = rerank_dist.rerank_gather_dist_chunked(cand, queries, table)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err = float(diff.max())
    rel = float((diff / want.abs().clamp_min(1e-30)).max())
    same = torch.equal(got, want)
    log(f"  rerank_gather_dist [{name}]: Q={cand.shape[0]} L={cand.shape[1]} "
        f"M={cand.shape[2]} K={table.shape[1]} D={table.shape[2]}: "
        f"bit-identical={same} max_abs_err={err} max_rel_err={rel}")
    ok = same if exact else torch.allclose(got, want, **RERANK_TOL)
    if not ok:
        raise AssertionError(f"rerank_gather_dist [{name}] differs from the "
                             "plain version")
    return err, rel


def recall_at(ids, gt, k: int) -> float:
    """Share of queries whose exact nearest neighbour is in the first k."""
    return float((ids[:, :k] == gt[:, None]).any(dim=1).float().mean())


def near_tie_free(torch, d, tol=RERANK_TOL):
    """(Q, k) True where d[q, j] is apart from both neighbours in its row
    by more than the tolerance (where ids must agree exactly)."""
    gap = (d[:, 1:] - d[:, :-1]).abs() > \
        tol["atol"] + tol["rtol"] * d[:, 1:].abs()
    apart = torch.ones_like(d, dtype=torch.bool)
    apart[:, 1:] &= gap
    apart[:, :-1] &= gap
    return apart


def round_trip(torch, index_cls, index, queries, k, D, I):
    """Save ``index`` under build/, load it back, and require the same
    search results."""
    save_dir = ROOT / "build" / f"chip_smoke_{index.kind}"
    if save_dir.exists():
        shutil.rmtree(save_dir)
    index.save(save_dir)
    loaded = index_cls.load(save_dir)
    D2, I2 = loaded.search(queries, k)
    same = torch.equal(D2, D) and torch.equal(I2, I)
    shutil.rmtree(save_dir)
    log(f"  save/load round trip ({index.kind}): results identical={same}")
    if not same:
        raise AssertionError("save/load changed the search results")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401 — pins the fp32 matmul flags
    from repro_torch.configs.unq_paper import DEEP_8B
    from repro_torch.core import unq
    from repro_torch.data import descriptors
    from repro_torch.index import (Index, OPQIndex, UNQIndex,
                                   candidate_generator_for, index_factory)
    from repro_torch.core import baselines
    from repro_torch.kernels import (adc_scan, build, lut_quant, ops, ref,
                                     rerank_dist, topl_scan, unq_encode)

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
        log(f"  {res.name}.cu: {res.seconds:.2f} s")
        for line in ptxas_report(res.log):
            log(f"    {line}")

    # -- data and weights (set-up) -------------------------------------------------
    cfg = DEEP_8B
    t0 = time.perf_counter()
    ds = descriptors.make_synthetic_dataset(
        "deep", n_train=N_TRAIN, n_base=N_BASE, n_query=N_QUERY,
        seed=args.seed, compute_gt=False)
    params, state = unq.numpy_params(cfg, args.seed, bn_stats=True,
                                     center=ds.train[:10_000])
    model = unq.unq_from_jax(params, state, cfg)
    gt = torch.as_tensor(descriptors.exact_knn(ds.queries, ds.base, k=1,
                                               device="cuda")[:, 0])
    log(f"set-up: {N_TRAIN} x {cfg.dim} training vectors (the paper's "
        f"learning set is {PAPER_N_TRAIN}: cut {PAPER_N_TRAIN // N_TRAIN}x), "
        f"{N_BASE} base, {N_QUERY} queries with exact nearest neighbours, "
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
    real = luts_all[:sub].contiguous()
    parity = {"float32": 0.0, "float16": 0.0, "int8": 0.0}

    def check(dtype, *a, **kw):
        parity[dtype] = max(parity[dtype], scan_parity(
            torch, topl_scan, ops, lut_quant, *a, lut_dtype=dtype, **kw))

    check("float32", codes_rand, real, zeros, None, 500, "real LUTs")
    int_luts = torch.randint(-2, 3, (sub, cfg.num_codebooks, 256),
                             device=dev, generator=gen).float()
    check("float32", codes_rand, int_luts, zeros, None, 500,
          "tie-heavy integer LUTs")
    n_rag = n1 - 17                    # no multiple of the 256-row tile
    # ~400 kept points per query < L: +inf (filtered) entries reach the
    # result and must keep their real ids in ascending order
    keep = torch.rand((sub, n_rag), device=dev, generator=gen) < 4e-4
    qbias = torch.where(keep, 0.0, float("inf"))
    rbias = torch.randint(-1, 2, (n_rag,), device=dev,
                          generator=gen).float()
    codes_rag = codes_rand[:n_rag].contiguous()
    check("float32", codes_rag, int_luts, rbias, qbias, 500,
          "filter qbias, ragged N", need_inf=True)
    # the quantized faces at the pool of L=500, overfetch 2
    pool = lut_quant.pool_width(500, 2, n1)
    for dtype in ("float16", "int8"):
        check(dtype, codes_rand, real, zeros, None, pool, "real LUTs")
        check(dtype, codes_rag, real, rbias, qbias, pool,
              "filter qbias, ragged N", need_inf=True)
    # wide heaps and wide codebooks (ROADMAP C1): fewer queries per block
    for topl in (1025, 1500, 4096):
        check("float32", codes_rand, real, zeros, None, topl,
              "real LUTs, wide heap")
    codes32 = torch.randint(0, 256, (100_000, 32), dtype=torch.uint8,
                            device=dev, generator=gen)
    luts32 = torch.randn((sub, 32, 256), device=dev, generator=gen)
    check("float32", codes32, luts32, zeros[:100_000], None, 500,
          "M=32 (PQ32x256 width)")
    del qbias, keep, codes32, luts32

    # quantize_luts on the card against the same call on the CPU
    q_same = []
    for dtype in ("float16", "int8"):
        got_q, got_s = lut_quant.quantize_luts(luts_all, dtype)
        want_q, want_s = lut_quant.quantize_luts(luts_all.cpu(), dtype)
        q_same.append(torch.equal(got_q.cpu(), want_q) and
                      (want_s is None or torch.equal(got_s.cpu(), want_s)))
    log(f"  quantize_luts on the card vs the CPU (Q={luts_all.shape[0]}, "
        f"float16 tables; int8 codes and scales): bit-identical={q_same}")
    if not all(q_same):
        raise AssertionError("quantize_luts differs between card and CPU")

    # the materialized scans
    got1 = ops.adc_scan(codes_rand, luts_all[0])
    want1 = ref.adc_scan_ref(codes_rand, luts_all[0])
    same1 = torch.equal(got1, want1)
    as_err = float((got1 - want1).abs().max())
    log(f"  adc_scan: N={n1} M={cfg.num_codebooks} K=256: bit-identical="
        f"{same1} max_abs_err={as_err}")
    gotb = ops.adc_scan_batch(codes_rand, luts_all)
    wantb = ref.adc_scan_batch_ref(codes_rand, luts_all)
    sameb = torch.equal(gotb, wantb)
    asb_err = float((gotb - wantb).abs().max())
    log(f"  adc_scan_batch: Q={luts_all.shape[0]} N={n1} "
        f"M={cfg.num_codebooks} K=256: bit-identical={sameb} "
        f"max_abs_err={asb_err}")
    if not (same1 and sameb):
        raise AssertionError("adc_scan / adc_scan_batch differ from the "
                             "plain version")
    del codes_rand, codes_rag, gotb, wantb

    # stage 2 of the table quantizers, on a briefly trained OPQ table
    # (dense: the rotation is folded in) and on an integer-valued one
    t0 = time.perf_counter()
    quick = index_factory("OPQ8x256", dim=cfg.dim).train(
        ds.train[:20_000], outer_iters=2, kmeans_iters=5)
    log(f"  (an OPQ table from 2 + 1 rounds of k-means on 20,000 vectors "
        f"in {time.perf_counter() - t0:.1f} s)")
    cand_rand = torch.randint(0, 256, (N_QUERY, 500, 8), dtype=torch.uint8,
                              device=dev, generator=gen)
    rr_err, _ = rerank_parity(torch, ops, rerank_dist, cand_rand,
                              queries_dev, quick._decode_table(),
                              "real OPQ table", exact=False)
    int_table = torch.randint(-3, 4, (8, 256, cfg.dim), device=dev,
                              generator=gen).float()
    int_queries = torch.randint(-4, 5, (N_QUERY, cfg.dim), device=dev,
                                generator=gen).float()
    rerank_parity(torch, ops, rerank_dist, cand_rand, int_queries, int_table,
                  "integer table", exact=True)
    del quick, cand_rand, int_table, int_queries

    # -- 4. the UNQ path ---------------------------------------------------------------
    log("== 4. UNQ path: index_factory -> from_trained -> add -> search")
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

    counters = {"unq_encode": unq_encode.unq_encode_cuda,
                "adc_scan_topl": topl_scan.adc_scan_topl_cuda,
                "rerank_gather_dist": rerank_dist.rerank_gather_dist_cuda,
                "adc_scan": adc_scan.adc_scan_cuda,
                "adc_scan_batch": adc_scan.adc_scan_batch_cuda}

    def counted(timer, name, fn):
        """Run ``fn`` under the timer with every launch count set to 0
        just before it; return its result and the counts just after."""
        for wrapper in counters.values():
            wrapper.launches = 0
        out = timer(name, fn)
        return out, {kern: w.launches for kern, w in counters.items()}

    def add_all(index):
        lo = 0
        for b in batches:
            index.add(base_dev[lo:lo + b])
            lo += b

    _, launches_add = counted(timer, "encode (add)", lambda: add_all(index))
    k = K
    (D_cold, I_cold), launches_search = counted(
        timer, "search, first call (cold)",
        lambda: index.search(queries_dev, k))
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

    round_trip(torch, Index, index, queries_dev, k, D, I)
    del cpu_index, gpu_small

    # the reduced-precision stage 1 on the UNQ path: f16 tables, a pool
    # of 2L re-scored exactly
    qt = Timer(torch)
    q16 = {"lut_dtype": "float16", "overfetch": 2}
    (uD16, uI16), u16_launches = counted(
        qt, "search f16 x2, first call", lambda: index.search(
            queries_dev, k, **q16))
    u_d2_16, u_cand16 = qt("stage 1 f16 x2", lambda: stage1.topl(
        index.codes, luts, None, topl=index.rerank, **q16))
    uD16w, uI16w = qt("search f16 x2 (warm)",
                      lambda: index.search(queries_dev, k, **q16))
    u16_recall = pool_recall(torch, u_cand16, cand)
    for name, ms in qt.ms.items():
        log(f"  {name}: {ms:.3f} ms")
    log(f"  f16 x2: kernel launches in one search {u16_launches}; recall@L "
        f"of its stage 1 against the exact stage 1: {u16_recall:.6f}; "
        f"final ids equal to the exact search on "
        f"{float((uI16 == I).float().mean()):.6f} of entries")
    if u16_launches["adc_scan_topl"] <= 0 or not (
            torch.equal(uD16, uD16w) and torch.equal(uI16, uI16w)):
        raise AssertionError("the f16 UNQ search did not launch the scan "
                             "kernel or differs between calls")
    launches_unq_f16 = u16_launches

    # -- 5. the OPQ path -----------------------------------------------------------------
    log("== 5. OPQ path: index_factory -> train -> add -> search")
    spec = "OPQ8x256,Rerank500"
    opq = index_factory(spec, dim=cfg.dim)
    if not (isinstance(opq, OPQIndex) and opq.rerank == 500
            and (opq.num_books, opq.book_size) == (8, 256)):
        raise AssertionError(f"{spec} did not build an 8x256 OPQIndex")
    train_dev = torch.as_tensor(ds.train, device=dev)
    torch.cuda.reset_peak_memory_stats()
    otimer = Timer(torch)
    _, o_train = counted(otimer, "train", lambda: opq.train(train_dev))
    _, o_add = counted(otimer, "encode (add)", lambda: add_all(opq))
    (oD_cold, oI_cold), o_search = counted(
        otimer, "search, first call (cold)",
        lambda: opq.search(queries_dev, k))
    o_luts = otimer("LUT build", lambda: opq._build_luts(queries_dev))
    o_d2, o_cand = otimer("stage 1", lambda: stage1.topl(
        opq.codes, o_luts, None, topl=opq.rerank))
    oD_st, oI_st = otimer("stage 2", lambda: opq._rerank_topk(
        queries_dev, o_cand, k))
    oD, oI = otimer("search total", lambda: opq.search(queries_dev, k))
    o_peak = torch.cuda.max_memory_allocated()
    for name, ms in otimer.ms.items():
        log(f"  {name}: {ms:.3f} ms")
    o_launches = {"train": o_train, "add": o_add, "search": o_search}
    log(f"  trained on {train_dev.shape[0]} vectors (outer_iters=8, "
        f"kmeans_iters=10, final k-means 25); added {opq.ntotal} in "
        f"{len(batches)} batches; searched {N_QUERY} queries at k={k}, "
        f"L={opq.rerank}")
    log(f"  max_memory_allocated: {o_peak} B ({o_peak / 2**30:.2f} GiB)")
    log(f"  kernel launches per phase: {o_launches}")
    gt_dev = gt.to(dev)
    recalls = {f"R@{r}": recall_at(oI, gt_dev, r) for r in (1, 10, 100)}
    log(f"  recall against the exact nearest neighbour: {recalls}")
    if o_search["adc_scan_topl"] <= 0 or o_search["rerank_gather_dist"] <= 0:
        raise AssertionError(f"a kernel was not launched in the OPQ search: "
                             f"{o_search}")

    if oD.shape != (q, k) or oI.shape != (q, k):
        raise AssertionError(f"OPQ search returned {oD.shape}, {oI.shape}")
    if not torch.isfinite(oD).all() or (oD < 0).any() \
            or (oD[:, 1:] < oD[:, :-1]).any():
        raise AssertionError("OPQ distances must be finite, >= 0, ascending")
    if (oI < 0).any() or (oI >= opq.ntotal).any():
        raise AssertionError("OPQ ids out of range")
    if not all(torch.equal(a, b) for a, b in
               ((oD, oD_st), (oI, oI_st), (oD, oD_cold), (oI, oI_cold))):
        raise AssertionError("OPQ search() differs between calls or from "
                             "its stages run apart")
    table = opq._decode_table()
    o_cand_codes = opq.codes[o_cand.long()]                  # (Q, L, M)
    sq = 32
    s2_err, s2_rel = rerank_parity(
        torch, ops, rerank_dist, o_cand_codes[:sq].contiguous(),
        queries_dev[:sq].contiguous(), table, f"OPQ path stage 2, {sq} "
        "queries", exact=False)
    d1_plain = rerank_dist.rerank_gather_dist_chunked(
        o_cand_codes, queries_dev, table)
    pd, order = torch.sort(d1_plain, dim=1, stable=True)
    pd, pi = pd[:, :k], torch.gather(o_cand, 1, order[:, :k])
    apart = near_tie_free(torch, pd)
    if not (torch.allclose(oD, pd, **RERANK_TOL)
            and torch.equal(oI[apart], pi[apart])):
        raise AssertionError("the OPQ search differs from the plain stage 2")
    log(f"  against the plain stage 2 on all {q} queries: D max abs diff "
        f"{float((oD - pd).abs().max())}, ids equal on all "
        f"{int(apart.sum())} positions apart from near-ties")

    # a shared filter keeping fewer points than k: the pool underfills,
    # and its filtered slots must come back as (+inf, -1)
    n_keep = 60
    keep = torch.zeros(opq.ntotal, dtype=torch.bool, device=dev)
    keep[torch.randperm(opq.ntotal, device=dev, generator=gen)[:n_keep]] = \
        True
    rerank_dist.rerank_gather_dist_cuda.launches = 0
    fD, fI = opq.search(queries_dev, k, filter_mask=keep)
    torch.cuda.synchronize()
    fin = torch.isfinite(fD)
    if not ((fin.sum(dim=1) == n_keep).all() and (fI[~fin] == -1).all()
            and keep[fI[fin].long()].all()
            and rerank_dist.rerank_gather_dist_cuda.launches == 1):
        raise AssertionError("the filtered OPQ search did not report its "
                             "underfilled pool as (+inf, -1)")
    log(f"  filtered search keeping {n_keep} of {opq.ntotal} points: "
        f"{n_keep} finite results per query, all kept ids; the other "
        f"{k - n_keep} are (+inf, -1)")
    round_trip(torch, Index, opq, queries_dev, k, oD, oI)

    # the reduced-precision stage 1: a pool of overfetch * L under f16 or
    # i8 tables, re-scored with the exact f32 chain
    quant_launches = {"float16": [launches_unq_f16], "int8": []}
    bias0 = torch.zeros(opq.ntotal, device=dev)
    for dtype, over in (("float16", 2), ("int8", 2), ("int8", 3)):
        kw = {"lut_dtype": dtype, "overfetch": over}
        qt = Timer(torch)
        (qD, qI), q_launch = counted(
            qt, "search, first call", lambda: opq.search(queries_dev, k, **kw))
        q_d2, q_cand = qt("stage 1", lambda: stage1.topl(
            opq.codes, o_luts, None, topl=opq.rerank, **kw))
        qDw, qIw = qt("search (warm)", lambda: opq.search(queries_dev, k,
                                                          **kw))
        quant_launches[dtype].append(q_launch)
        # the plain quantized path on the same LUTs: the plain stream's
        # pool, the exact re-score, the same stage 2
        pool_l = lut_quant.pool_width(opq.rerank, over, opq.ntotal)
        qluts, scale = lut_quant.quantize_luts(o_luts, dtype)
        _, plain_pool = topl_scan.adc_scan_topl_stream(
            opq.codes, qluts, bias0, None, scale, topl=pool_l,
            n_valid=opq.ntotal)
        p_d2, p_cand = ops._rescore_flat(opq.codes, o_luts, bias0, None,
                                         plain_pool, opq.rerank)
        pD, pI = opq._rerank_topk(queries_dev, p_cand, k)
        same_stage1 = torch.equal(q_d2, p_d2) and torch.equal(q_cand, p_cand)
        same_final = torch.equal(qD, pD) and torch.equal(qI, pI)
        rec = pool_recall(torch, q_cand, o_cand)
        q_recalls = {f"R@{r}": recall_at(qI, gt_dev, r) for r in (1, 10, 100)}
        tag = f"{dtype} x{over} (pool {pool_l})"
        for name, ms in qt.ms.items():
            log(f"  {tag} {name}: {ms:.3f} ms")
        log(f"  {tag}: recall@L of stage 1 against the exact stage 1 "
            f"{rec:.6f}; {q_recalls}; stage 1 equal to the plain quantized "
            f"path={same_stage1}, final (D, I) equal={same_final}; launches "
            f"in one search {q_launch}")
        if q_launch["adc_scan_topl"] <= 0 or not (same_stage1 and same_final
                                                   and torch.equal(qD, qDw)
                                                   and torch.equal(qI, qIw)):
            raise AssertionError(f"the {tag} search differs from the plain "
                                 "quantized path or did not launch its scan")
        if rec < 0.99:
            raise AssertionError(f"{tag}: stage-1 recall {rec} below 0.99")
    del qluts, scale, plain_pool

    # the same trained index under Scan(onehot): the materialized (Q, N)
    # stage 1 (adc_scan_batch), which must equal the streaming search
    # (built from the factory string around the trained model; its add
    # must give the streaming index's codes back)
    mat = index_factory("OPQ8x256,Rerank500,Scan(onehot)", dim=cfg.dim)
    mat.model = opq.model
    add_all(mat)
    if mat.backend != "onehot" or not torch.equal(mat.codes, opq.codes):
        raise AssertionError("Scan(onehot) did not pin the onehot backend "
                             "or its add gave other codes")
    mt = Timer(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    (mD, mI), m_launch = counted(mt, "search, first call",
                                 lambda: mat.search(queries_dev, k))
    m_peak = torch.cuda.max_memory_allocated() - base_mem
    m_d2, m_cand = mt("stage 1", lambda: candidate_generator_for(
        dev, mat.backend).topl(mat.codes, o_luts, None, topl=mat.rerank))
    mDw, mIw = mt("search (warm)", lambda: mat.search(queries_dev, k))
    for name, ms in mt.ms.items():
        log(f"  Scan(onehot) {name}: {ms:.3f} ms")
    m_same = all(torch.equal(a, b) for a, b in (
        (mD, oD), (mI, oI), (mDw, oD), (mIw, oI), (m_d2, o_d2),
        (m_cand, o_cand)))
    log(f"  Scan(onehot): Q={N_QUERY} N={mat.ntotal}: peak memory above the "
        f"index {m_peak} B ({m_peak / 2**30:.2f} GiB; the (Q, N) f32 matrix "
        f"alone is {4 * N_QUERY * mat.ntotal} B); stage 1 and search (d, "
        f"ids) equal to the streaming search bit for bit={m_same}; "
        f"launches {m_launch}")
    if not m_same or m_launch["adc_scan_batch"] <= 0 \
            or m_launch["adc_scan_topl"] != 0:
        raise AssertionError("the Scan(onehot) search differs from the "
                             "streaming one or did not run adc_scan_batch")
    del mat

    # search_pq: one adc_scan per query over the OPQ path's codes
    n_pq = min(100, N_QUERY)
    st = Timer(torch)
    pq_ids, pq_launch = counted(st, "search_pq", lambda: baselines.search_pq(
        opq.model, queries_dev[:n_pq], opq.codes, k))
    pq_recalls = {f"R@{r}": recall_at(pq_ids, gt_dev[:n_pq], r)
                  for r in (1, 10, 100)}
    same_q = {f"R@{r}": recall_at(oI[:n_pq], gt_dev[:n_pq], r)
              for r in (1, 10, 100)}
    plain_luts = opq.model.lut(queries_dev[:8])
    plain_ids = torch.stack([
        torch.sort(ref.adc_scan_ref(opq.codes, lt), stable=True)
        .indices[:k] for lt in plain_luts]).to(torch.int32)
    pq_same = torch.equal(pq_ids[:8], plain_ids)
    log(f"  search_pq over {opq.ntotal} OPQ codes, {n_pq} queries, k={k}: "
        f"{st.ms['search_pq']:.3f} ms; {pq_recalls} (the OPQ index's "
        f"search on the same queries: {same_q}); ids of 8 queries equal "
        f"to the plain scan + stable sort={pq_same}; launches {pq_launch}")
    if pq_launch["adc_scan"] != n_pq or not pq_same:
        raise AssertionError("search_pq did not run one adc_scan per query "
                             "or differs from the plain version")

    # -- 6. kernel timings -----------------------------------------------------------------
    log("== 6. kernels at the main paths' shapes (CUDA events)")
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
    d = cfg.dim
    rr_ms = cuda_ms(torch, lambda: ops.rerank_gather_dist(
        o_cand_codes, queries_dev, table), reps=20)
    rr_plain = cuda_ms(torch, lambda: rerank_dist.rerank_gather_dist_chunked(
        o_cand_codes, queries_dev, table), reps=5)
    # per (q, l): (M-1)*D chain adds, D subtractions and D FMAs that
    # square and accumulate, each one f32 instruction at the add rate
    rr_bound = bound_ms(float(q) * L * (m_ + 1) * d, FP32_ADDS,
                        q * L * m_ + 4.0 * (m_ * k_ * d + q * d + q * L))
    launches = {name: launches_add[name] + launches_search[name]
                + sum(ph[name] for ph in o_launches.values())
                for name in counters}
    # the quantized faces at the OPQ path's shapes, pool of L=500 x2
    pool = lut_quant.pool_width(L, 2, n)
    qfaces = {}
    for dtype, lut_bytes in (("float16", 2), ("int8", 1)):
        qluts, scale = lut_quant.quantize_luts(o_luts, dtype)
        ms = cuda_ms(torch, lambda: ops._scan_topl_run(
            opq.codes, qluts, scale, bias0, None, topl=pool), reps=10)
        plain = cuda_ms(torch, lambda: topl_scan.adc_scan_topl_stream(
            opq.codes, qluts, bias0, None, scale, topl=pool, n_valid=n),
            reps=2, warmup=1)
        # one chain add per part; i8 tables also need one multiply by the
        # scale per table entry (Q*M*K: the dequantized table does not
        # depend on the row), each one f32 instruction at the add rate
        n_ops = float(q) * n * m_ + (q * m_ * k_ if scale is not None else 0)
        bound = bound_ms(n_ops, FP32_ADDS,
                         n * m_ + 4.0 * n + lut_bytes * q * m_ * k_
                         + (4.0 * q * m_ if scale is not None else 0.0)
                         + 8.0 * q * pool)
        qfaces[dtype] = (ms, plain, bound,
                         sum(ph["adc_scan_topl"]
                             for ph in quant_launches[dtype]))
        # the same face at the f32 face's L, to part the table type's
        # cost from the wider heap's
        ms_l = cuda_ms(torch, lambda: ops._scan_topl_run(
            opq.codes, qluts, scale, bias0, None, topl=L), reps=10)
        log(f"  adc_scan_topl {dtype} at L={L} instead of the pool "
            f"{pool}: {ms_l:.4f} ms")
    ms_l = cuda_ms(torch, lambda: ops._scan_topl_run(
        opq.codes, o_luts, None, bias0, None, topl=pool), reps=10)
    log(f"  adc_scan_topl float32 at L={pool} (the pool): {ms_l:.4f} ms")
    del qluts, scale
    # the materialized scans at the materialized path's shapes
    ocodes = opq.codes
    as_ms = cuda_ms(torch, lambda: ops.adc_scan(ocodes, o_luts[0]), reps=50)
    as_plain = cuda_ms(torch, lambda: ref.adc_scan_ref(ocodes, o_luts[0]),
                       reps=20)
    as_bound = bound_ms(float(n) * m_, FP32_ADDS,
                        n * m_ + 4.0 * n + 4.0 * m_ * k_)
    asb_ms = cuda_ms(torch, lambda: ops.adc_scan_batch(ocodes, o_luts),
                     reps=10)
    asb_plain = cuda_ms(torch, lambda: ref.adc_scan_batch_ref(ocodes, o_luts),
                        reps=3, warmup=1)
    asb_bound = bound_ms(float(q) * n * m_, FP32_ADDS,
                         n * m_ + 4.0 * q * m_ * k_ + 4.0 * q * n)
    # the library call: one embedding_bag in sum mode over the (N, M)
    # flat indices code + m*K into the tables laid out (M*K, Q) (both
    # made outside the timing); it writes (N, Q), the transpose
    flat = (ocodes.long() + torch.arange(m_, device=dev) * k_).contiguous()
    lut_col = o_luts[0].reshape(m_ * k_, 1)
    lut_cols = o_luts.permute(1, 2, 0).reshape(m_ * k_, q).contiguous()
    as_lib = cuda_ms(torch, lambda: F.embedding_bag(
        flat, lut_col, mode="sum"), reps=50)
    as_lib_same = torch.equal(
        F.embedding_bag(flat, lut_col, mode="sum")[:, 0],
        ops.adc_scan(ocodes, o_luts[0]))
    asb_lib = cuda_ms(torch, lambda: F.embedding_bag(
        flat, lut_cols, mode="sum"), reps=10)
    asb_lib_same = torch.equal(F.embedding_bag(flat, lut_cols, mode="sum").T,
                               ops.adc_scan_batch(ocodes, o_luts))
    log(f"  library embedding_bag(mode='sum'): adc_scan {as_lib:.4f} ms, "
        f"bit-identical={as_lib_same}; adc_scan_batch {asb_lib:.4f} ms, "
        f"bit-identical (transposed)={asb_lib_same}")
    del flat, lut_cols
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
         "launches": launches["adc_scan_topl"],
         "max_abs_err": parity["float32"],
         "ms": scan_ms, "plain_ms": scan_plain, "bound_ms": scan_bound[0],
         "bound_by": scan_bound[1], "library_ms": None},
        {"name": "rerank_gather_dist", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rerank_dist.cu",
         "replaces": "src/repro/kernels/rerank_dist.py:99",
         "launches": launches["rerank_gather_dist"],
         "max_abs_err": max(rr_err, s2_err), "ms": rr_ms,
         "plain_ms": rr_plain, "bound_ms": rr_bound[0],
         "bound_by": rr_bound[1], "library_ms": None},
    ]
    for dtype, name in (("float16", "adc_scan_topl_f16"),
                        ("int8", "adc_scan_topl_i8")):
        ms, plain, bound, n_launch = qfaces[dtype]
        kernels.append(
            {"name": name, "route": "cuda",
             "source": "src/repro_torch/kernels/csrc/topl_scan.cu",
             "replaces": "src/repro/kernels/topl_scan.py:157",
             "launches": n_launch, "max_abs_err": parity[dtype], "ms": ms,
             "plain_ms": plain, "bound_ms": bound[0], "bound_by": bound[1],
             "library_ms": None})
    kernels += [
        {"name": "adc_scan", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/adc_scan.cu",
         "replaces": "src/repro/kernels/adc_scan.py:63",
         "launches": pq_launch["adc_scan"], "max_abs_err": as_err,
         "ms": as_ms, "plain_ms": as_plain, "bound_ms": as_bound[0],
         "bound_by": as_bound[1], "library_ms": as_lib},
        {"name": "adc_scan_batch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/adc_scan.cu",
         "replaces": "src/repro/kernels/adc_scan.py:121",
         "launches": m_launch["adc_scan_batch"], "max_abs_err": asb_err,
         "ms": asb_ms, "plain_ms": asb_plain, "bound_ms": asb_bound[0],
         "bound_by": asb_bound[1], "library_ms": asb_lib},
    ]
    shapes = {"unq_encode": f"B={b} M={m_} K={k_} d_c={dc}",
              "adc_scan_topl": f"Q={q} N={n} M={m_} K={k_} L={L}",
              "rerank_gather_dist": f"Q={q} L={L} M={m_} K={k_} D={d}",
              "adc_scan_topl_f16": f"Q={q} N={n} M={m_} K={k_} pool={pool}",
              "adc_scan_topl_i8": f"Q={q} N={n} M={m_} K={k_} pool={pool}",
              "adc_scan": f"N={n} M={m_} K={k_}",
              "adc_scan_batch": f"Q={q} N={n} M={m_} K={k_}"}
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
    log(f"  rerank_gather_dist: a second ceiling, its Q*L*M*D table reads "
        f"from shared memory at no bank conflict, is "
        f"{q * L * m_ * d / SMEM_WORDS_PER_S * 1e3:.4f} ms (the kernel "
        f"reads the table through L2)")
    log(f"total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Evidence for the kernel decisions on the GPU: one process, one card.

    python tools/gpu_kernel_report.py [--out chiprun_out/kernel_report.json]

  * int8: compiles the int8 x int8 -> int32 trunk convolution
    (models/quantize.int8_conv) for the 1-channel stem, a 64->64 conv and a
    64-group depthwise conv, and the whole int8 superpoint_pretrained trunk;
    records whether each compiled, whether XLA sent it to cuDNN, and its
    error against the fp32 convolution of the same quantized values.
  * stages: profiler traces of the flagship hybrid (S=256, L=128, K=512;
    kernel and XLA scan body) and the reference-parity cell (S=500,
    L=1024, K=1024; kernel); device time per named scope (frontend,
    matching, solve_prep, prior_scan) and of the fused_solve kernel.
  * timing: both cells end to end, the kernel at two num_warps values vs
    the XLA scan body, median of 5 after a compile run.

Prints one summary line per measurement and writes everything to --out.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SCOPES = ("frontend", "matching", "solve_prep", "prior_scan")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def int8_report() -> list:
    import jax
    import jax.numpy as jnp

    from spsvo.models import zoo
    from spsvo.models.quantize import int8_conv
    rows = []
    rng = np.random.default_rng(0)
    cpu = jax.devices("cpu")[0]
    for name, cin, cout, groups in (("stem 1->64", 1, 64, 1),
                                    ("conv 64->64", 64, 64, 1),
                                    ("depthwise 64 groups", 64, 64, 64)):
        xq = rng.integers(-127, 128, (2, 120, 392, cin)).astype(np.int8)
        wq = rng.integers(-127, 128, (3, 3, cin // groups, cout)).astype(
            np.int8)

        ws = np.full((cout,), 0.01, np.float32)

        def conv(x, w, ws, groups=groups):
            # the model's int8 convolution: int8 x int8 contraction,
            # dequantized to fp32 (XLA:GPU has no int32-output cuDNN conv)
            return int8_conv(x.astype(jnp.float32) / 127.0, w, ws, (1, 1),
                             "SAME", (1, 1), groups, a_scale=1 / 127.0)
        row = {"case": name}
        try:
            comp = jax.jit(conv).lower(xq, wq, ws).compile()
            hlo = comp.as_text()
            row["compiled"] = True
            row["cudnn_custom_call"] = "cudnn" in hlo
            row["s8_operands_in_hlo"] = "s8[" in hlo
            got = np.asarray(comp(xq, wq, ws))
            ref = np.asarray(jax.jit(conv)(*jax.device_put((xq, wq, ws),
                                                           cpu)))
            row["max_abs_diff_vs_cpu"] = float(np.abs(got - ref).max())
            row["max_abs_cpu"] = float(np.abs(ref).max())
        except Exception as e:  # a refusal is the finding being recorded
            row["compiled"] = False
            row["error"] = f"{type(e).__name__}: {str(e)[:300]}"
        rows.append(row)
        print("int8", json.dumps(row), flush=True)
    row = {"case": "superpoint_pretrained int8 trunk, 2x120x392"}
    try:
        apply8, p8 = zoo.load_model("superpoint_pretrained", int8=True)
        x = jnp.asarray(rng.random((2, 120, 392, 1), np.float32))
        comp = jax.jit(apply8).lower(p8, x).compile()
        out = comp(p8, x)
        ref = jax.jit(apply8)(jax.device_put(p8, cpu), jax.device_put(x, cpu))
        row["compiled"] = True
        row["cudnn_custom_calls"] = comp.as_text().count("cudnn")
        d = np.asarray(out["output_desc"])
        row["finite"] = bool(np.isfinite(d).all())
        row["desc_cos_vs_cpu_p1"] = float(np.percentile(
            (d * np.asarray(ref["output_desc"])).sum(-1), 1))
    except Exception as e:
        row["compiled"] = False
        row["error"] = f"{type(e).__name__}: {str(e)[:300]}"
    rows.append(row)
    print("int8", json.dumps(row), flush=True)
    return rows


def drive(seed: int = 0, n: int = 64):
    import chip_smoke
    _, gt, _, _, images, P_l, P_r = chip_smoke.build_drive(seed, n)
    return images, P_l, P_r, gt


def reduce_trace(logdir: str) -> dict:
    """Device time (ns) per named scope and per kernel name, from the
    xplane trace: device events are attributed to a scope when any of
    their string stats names it (XLA carries the op's scope path there)."""
    from jax.profiler import ProfileData
    pb = glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                   recursive=True)[0]
    pd = ProfileData.from_file(pb)
    by_scope = collections.Counter()
    by_name = collections.Counter()
    total = 0
    busy_lo, busy_hi = None, None
    stat_keys = set()
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                d = ev.duration_ns
                total += d
                by_name[ev.name] += d
                lo, hi = ev.start_ns, ev.start_ns + d
                busy_lo = lo if busy_lo is None else min(busy_lo, lo)
                busy_hi = hi if busy_hi is None else max(busy_hi, hi)
                text = [ev.name]
                for k, v in ev.stats:
                    stat_keys.add(k)
                    if isinstance(v, str):
                        text.append(v)
                text = " ".join(text)
                for s in SCOPES:
                    if s in text:
                        by_scope[s] += d
                        break
                else:
                    if "fused_solve" in text:
                        by_scope["prior_scan"] += d
    return {"device_ns_total": total, "by_scope_ns": dict(by_scope),
            "window_ns": (busy_hi - busy_lo) if busy_lo is not None else 0,
            "top_kernels_ns": by_name.most_common(25),
            "fused_solve_ns": sum(v for k, v in by_name.items()
                                  if "fused_solve" in k),
            "stat_keys": sorted(stat_keys)}


def cells():
    from spsvo import presets
    flag = presets.flagship()
    parity = dataclasses.replace(flag, ransac_iterations=500,
                                 max_keypoints=1024, solve_slots=1024)
    return {"flagship": flag, "parity": parity}


def stage_report(images, P_l, P_r) -> dict:
    import chip_smoke
    out = {}
    for cell, cfg in cells().items():
        bodies = [("kernel", cfg)]
        if cell == "flagship":
            bodies.append(("xla", dataclasses.replace(
                cfg, use_pallas_solver=False)))
        for body, c in bodies:
            import jax
            from spsvo.utils.profiling import device_trace
            chip_smoke.run_hybrid(c, images, P_l, P_r, 0)       # compile
            d = tempfile.mkdtemp()
            with device_trace(d):
                chip_smoke.run_hybrid(c, images, P_l, P_r, 0)
            jax.effects_barrier()
            r = reduce_trace(d)
            tot = max(r["device_ns_total"], 1)
            shares = {k: v / tot for k, v in r["by_scope_ns"].items()}
            print(f"stages {cell}/{body}: device busy "
                  f"{r['device_ns_total'] / 1e6:.3f} ms; shares "
                  + ", ".join(f"{k} {v:.3f}" for k, v in shares.items())
                  + f"; fused_solve {r['fused_solve_ns'] / 1e6:.3f} ms",
                  flush=True)
            out[f"{cell}/{body}"] = r
    return out


def timing_report(images, P_l, P_r, reps: int = 5) -> dict:
    import chip_smoke

    from spsvo.ops import solver_pallas
    default = solver_pallas.default_num_warps
    out = {}
    n = len(images)
    for cell, cfg in cells().items():
        variants = [("xla", dataclasses.replace(cfg, use_pallas_solver=False),
                     None)]
        warps = (2, 4) if cell == "flagship" else (4, 8)
        variants += [(f"kernel_w{w}", cfg, w) for w in warps]
        for name, c, w in variants:
            solver_pallas.default_num_warps = (
                default if w is None else (lambda Lp, w=w: w))
            t0 = time.perf_counter()
            _, diag, setup, times = chip_smoke.run_hybrid(c, images, P_l,
                                                          P_r, 0, reps=reps)
            med = float(np.median(times))
            out[f"{cell}/{name}"] = {"setup_s": setup, "times_s": times,
                                     "median_s": med, "fps": n / med}
            print(f"timing {cell}/{name}: {med * 1e3:.2f} ms median "
                  f"({n / med:.1f} frames/s), set-up {setup:.1f} s, "
                  f"wall {time.perf_counter() - t0:.1f} s", flush=True)
    solver_pallas.default_num_warps = default
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="chiprun_out/kernel_report.json")
    ap.add_argument("--parts", default="int8,stages,timing")
    args = ap.parse_args()
    import jax
    assert jax.default_backend() == "gpu", jax.default_backend()
    import spsvo  # noqa: F401
    report = {"card": card(), "device_kind": jax.devices()[0].device_kind}
    print("card:", report["card"], flush=True)
    parts = args.parts.split(",")
    if "int8" in parts:
        report["int8"] = int8_report()
    if "stages" in parts or "timing" in parts:
        images, P_l, P_r, _ = drive()
    if "stages" in parts:
        report["stages"] = stage_report(images, P_l, P_r)
    if "timing" in parts:
        report["timing"] = timing_report(images, P_l, P_r)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1, default=str)
    return 0


if __name__ == "__main__":
    sys.exit(main())

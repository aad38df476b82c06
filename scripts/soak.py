"""Endurance soak: long-horizon training health at reduced resolution.

The reference's "full quality" operating point is 600k iterations over ~8 h
(/root/reference/app.py:1347); this soak exercises the long-horizon failure
modes that scale surfaces — recompile churn, checkpoint-thread pileup,
capacity growth, host-memory creep — with a 100k+-iteration run at 256²
(VERDICT r4 item 6).  The trainer already emits the health signals per log
tick (rss_mb / recompiles / capacity / ckpt_threads, trainer.py train loop);
this script drives a GT-param training run and folds those events into
E2E_SOAK_256.json, REWRITTEN INCREMENTALLY by a monitor thread so a
truncated run still leaves an honest partial artifact.

    python scripts/soak.py --size 256 --iters 100000
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def summarize(ev_path: Path, t_start: float, meta: dict) -> dict:
    rows = []
    if ev_path.exists():
        for line in ev_path.read_text().splitlines():
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            if r.get("event") == "train_step" and r.get("t", 0) >= t_start:
                rows.append(r)
    rows.sort(key=lambda r: r["iter"])
    out = dict(meta)
    out["wall_minutes"] = round((time.time() - t_start) / 60, 2)
    out["n_log_ticks"] = len(rows)
    if not rows:
        return out
    iters = int(meta["iters"])
    bucket = max(iters // 20, 1)
    curve = []
    for b in range(0, iters, bucket):
        seg = [r for r in rows if b < r["iter"] <= b + bucket]
        if len(seg) >= 2:
            dt = seg[-1]["t"] - seg[0]["t"]
            di = seg[-1]["iter"] - seg[0]["iter"]
            if dt > 0:
                curve.append({
                    "iters": [seg[0]["iter"], seg[-1]["iter"]],
                    "it_per_sec": round(di / dt, 1),
                    "n_alive": seg[-1].get("n_alive"),
                    "psnr": round(seg[-1].get("psnr", 0.0), 2),
                })
    last = rows[-1]
    out.update(
        progress_iter=last["iter"],
        curve=curve,
        # the four long-horizon health signals (trainer.py log tick)
        rss_mb_first=rows[0].get("rss_mb"),
        rss_mb_last=last.get("rss_mb"),
        recompiles_total=last.get("recompiles"),
        capacity_first=rows[0].get("capacity"),
        capacity_last=last.get("capacity"),
        ckpt_threads_max=max(r.get("ckpt_threads", 0) for r in rows),
        n_alive_last=last.get("n_alive"),
        psnr_last=round(last.get("psnr", 0.0), 2),
        psnr_best=round(max(r.get("psnr", 0.0) for r in rows), 2),
    )
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--iters", type=int, default=100_000)
    ap.add_argument("--workdir", default="omfs4d_soak")
    ap.add_argument("--out", default="E2E_SOAK_256.json")
    args = ap.parse_args()

    from omfs4d.core.runtime import enable_compile_cache, require_gpu

    enable_compile_cache()
    dev = require_gpu()[0]

    from omfs4d.core.config import Config
    from omfs4d.io.synthetic import make_synthetic_dataset
    from omfs4d.pipeline.runner import Pipeline

    work = Path(args.workdir)
    work.mkdir(parents=True, exist_ok=True)
    print(f"[soak] device={dev.device_kind} size={args.size} "
          f"iters={args.iters}", flush=True)

    case = make_synthetic_dataset(
        work / "case", n_frames=args.frames, width=args.size,
        height=args.size, backend="auto")

    cfg = Config()
    cfg.pipeline.target_size = args.size
    cfg.pipeline.min_train_frames = min(50, max(args.frames - 2, 1))
    cfg.train.iterations = args.iters
    pipe = Pipeline(cfg, work / "wd")
    pipe.model = case["model"]

    meta = {
        "soak": True, "resolution": args.size, "iters": args.iters,
        "n_frames": args.frames, "device": dev.device_kind,
    }
    t0 = time.time()
    ev_path = work / "wd" / "events.jsonl"
    out_path = Path(args.out)
    stop = threading.Event()

    def monitor():
        while not stop.wait(60.0):
            try:
                out_path.write_text(
                    json.dumps(summarize(ev_path, t0, meta), indent=2))
            except Exception as e:         # noqa: BLE001 — keep soaking
                print(f"[soak] monitor write failed: {e}", flush=True)

    threading.Thread(target=monitor, daemon=True).start()
    try:
        pipe.train(Path(case["path"]), iterations=args.iters)
    finally:
        stop.set()
        final = summarize(ev_path, t0, meta)
        final["completed"] = final.get("progress_iter", 0) >= args.iters
        out_path.write_text(json.dumps(final, indent=2))
        print(f"[soak] wrote {out_path}: "
              f"{json.dumps({k: final.get(k) for k in ('progress_iter', 'wall_minutes', 'rss_mb_last', 'recompiles_total', 'psnr_last')})}",
              flush=True)


if __name__ == "__main__":
    main()

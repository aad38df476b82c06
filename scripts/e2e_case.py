"""Full end-to-end case with timings + fidelity: video -> track -> train ->
(a) zero-offset self-reconstruction vs GT frames (fidelity number) and
(b) surgical prediction render -> strict report.  Writes E2E_TIMING.json.

Runs on an NVIDIA GPU (it exits on a host without one):

    python scripts/e2e_case.py --size 256 --frames 60 --iters 2000

Reference spec for the fidelity leg: single_frame_experiment.py:108-163
(render same pose, zero offsets, compare vs GT) and BASELINE.md's >=0.5 dB
parity target; selfrecon_psnr is the whole-pipeline analogue.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--workdir", default="omfs4d_e2e")
    ap.add_argument("--out", default="E2E_TIMING.json")
    ap.add_argument("--max-per-tile", type=int, default=0,
                    help="override render.max_per_tile (0 = config default)")
    ap.add_argument("--gt-track", action="store_true",
                    help="bypass the tracker and train directly on the GT "
                         "synthetic FLAME params — isolates trainer fidelity "
                         "from tracker quality (dB attribution)")
    ap.add_argument("--set", action="append", default=[], metavar="K=V",
                    help="dotted config override, e.g. "
                         "train.opacity_reset_interval=0 (repeatable)")
    args = ap.parse_args()

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import numpy as np

    from omfs4d.core.runtime import card_info, enable_compile_cache, require_gpu

    enable_compile_cache()
    dev = require_gpu()[0]
    print(f"[e2e] {dev.device_kind}; {card_info()}", flush=True)

    from omfs4d.core.config import Config
    from omfs4d.io.synthetic import make_synthetic_dataset
    from omfs4d.io.video import read_image, stitch_video
    from omfs4d.pipeline.runner import Pipeline
    from omfs4d.ops.camera import look_at_camera

    work = Path(args.workdir)
    work.mkdir(parents=True, exist_ok=True)
    S = args.size
    stages: dict[str, float] = {}

    def timed(name):
        class _T:
            def __enter__(self):
                self.t = time.time(); return self
            def __exit__(self, *a):
                stages[name] = round(time.time() - self.t, 1)
                print(f"[e2e] {name}: {stages[name]}s", flush=True)
        return _T()

    # synthetic "patient capture" -> video (no landmarks anywhere on disk)
    print("[e2e] generating synthetic capture...", flush=True)
    case = make_synthetic_dataset(work / "case", n_frames=args.frames,
                                  width=S, height=S, backend="auto")
    video = stitch_video(work / "case" / "images", work / "input.mp4", fps=25)

    cfg = Config()
    cfg.pipeline.target_size = S
    cfg.pipeline.max_frames = args.frames
    cfg.pipeline.min_train_frames = min(50, max(args.frames - 2, 1))
    if args.max_per_tile:
        cfg.render.max_per_tile = args.max_per_tile
    cfg.train.iterations = args.iters
    from omfs4d.core.config import apply_override
    for kv in args.set:
        k, _, v = kv.partition("=")
        apply_override(cfg, k, v)
    if args.frames < 20:     # smoke-scale tracking budget
        for k, v in dict(steps_lmk_init_rigid=20, steps_lmk_init_all=15,
                         steps_rgb_init_texture=5, steps_rgb_init_all=5,
                         steps_rgb_init_offset=2, steps_rgb_sequential=2,
                         steps_global=6, epochs_global=1, n_shape=10,
                         n_expr=10, detector_steps=50,
                         detector_size=64).items():
            setattr(cfg.track, k, v)
    pipe = Pipeline(cfg, work / "wd")

    t_all = time.time()
    if args.gt_track:
        # ablation: the synthetic case dir IS a GT-parameter dataset in the
        # training contract; training on it directly measures the trainer's
        # fidelity ceiling with a perfect tracker
        pipe.model = case["model"]
        data_dir = Path(case["path"])
        print("[e2e] --gt-track: skipping preprocess/track", flush=True)
    else:
        with timed("preprocess"):
            frames_dir = pipe.preprocess(video)
        with timed("track"):
            sample = next((frames_dir / "images").glob("*.png"))
            h, w = read_image(sample).shape[:2]
            cam = look_at_camera(eye=(0, 0, 0.5), target=(0, 0, 0),
                                 fx=1.6 * max(w, h), width=w, height=h)
            data_dir = pipe.track(frames_dir, cam, landmark_method="auto")
    with timed(f"train_{args.iters}_iters"):
        model_dir = pipe.train(data_dir, iterations=args.iters)

    # (a) fidelity: zero-offset self-reconstruction vs GT frames
    det_self = work / "det_self"
    with timed("selfrecon_render"):
        pipe.render_surgery(model_dir, data_dir, work / "selfrecon.mp4",
                            0.0, 0.0, export_frames_dir=str(det_self))
    with timed("selfrecon_report"):
        rep = pipe.report(model_dir, det_self,
                          output_dir=work / "selfrecon_report")
    rows = rep.get("rows", [])
    selfrecon_psnr = (float(np.mean([r["psnr"] for r in rows]))
                      if rows else None)
    per_frame = sorted(float(r["psnr"]) for r in rows)
    psnr_stats = {
        "min": per_frame[0], "max": per_frame[-1],
        "std": float(np.std(per_frame)),
    } if per_frame else None
    print(f"[e2e] selfrecon_psnr={selfrecon_psnr} stats={psnr_stats}",
          flush=True)

    # keep the zero-offset renders: they are the baseline for the
    # region-excluded metric on the modified prediction (the raw strict
    # psnr scores surgically MOVED anatomy against unmoved GT and is
    # inherently capped; psnr_unchanged asks "did the prediction corrupt
    # anything the surgery did not touch?")
    import shutil
    from omfs4d.eval.reporting import find_latest_train_dir
    baseline_renders = work / "baseline_renders"
    if baseline_renders.exists():
        shutil.rmtree(baseline_renders)
    shutil.copytree(find_latest_train_dir(Path(model_dir)) / "renders",
                    baseline_renders)

    # (b) surgical prediction (modified params) + strict report
    det_mod = work / "det_mod"
    with timed("render_surgery"):
        pipe.render_surgery(model_dir, data_dir, work / "pred.mp4",
                            5.0, 3.0, export_frames_dir=str(det_mod))
    with timed("report"):
        rep_mod = pipe.report(model_dir, det_mod, output_dir=work / "report",
                              baseline_renders_dir=baseline_renders)
    front = rep_mod.get("summary", {}).get("by_bucket", {}).get("front", {})

    # it/s decay across densification: bucket the train_step events (the
    # 30k-iter headline run records how throughput falls as the cloud grows)
    train_ips_curve = None
    ev_path = work / "wd" / "events.jsonl"   # the pipeline's workdir subdir
    if not ev_path.exists():
        ev_path = work / "events.jsonl"
    if ev_path.exists():
        rows = []
        for line in ev_path.read_text().splitlines():
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            # a reused workdir's events.jsonl still holds past runs' steps;
            # only THIS run's events (t >= pipeline start) enter the curve
            if r.get("event") == "train_step" and r.get("t", 0) >= t_all:
                rows.append((r["iter"], r["t"], r.get("n_alive")))
        rows.sort()
        if len(rows) >= 3:
            bucket = max(args.iters // 10, 1)
            train_ips_curve = []
            for b in range(0, args.iters, bucket):
                seg = [r for r in rows if b < r[0] <= b + bucket]
                if len(seg) >= 2:
                    dt = seg[-1][1] - seg[0][1]
                    di = seg[-1][0] - seg[0][0]
                    if dt > 0:
                        train_ips_curve.append({
                            "iters": [seg[0][0], seg[-1][0]],
                            "it_per_sec": round(di / dt, 1),
                            "n_alive": seg[-1][2],
                        })

    out = {
        "e2e_minutes_per_case": round((time.time() - t_all) / 60, 2),
        "stages_sec": stages,
        "resolution": S,
        "n_frames": args.frames,
        "train_iters": args.iters,
        "backend": backend,
        "selfrecon_psnr": selfrecon_psnr,
        "selfrecon_psnr_stats": psnr_stats,
        "gt_track": bool(args.gt_track),
        "front_psnr_modified": front.get("psnr"),
        "front_psnr_unchanged": front.get("psnr_unchanged"),
        "train_ips_curve": train_ips_curve,
    }
    Path(args.out).write_text(json.dumps(out, indent=2))
    print(json.dumps(out))


if __name__ == "__main__":
    main()

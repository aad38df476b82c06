"""End-to-end pipeline: synthetic dataset -> train -> surgical render -> report.

This is the automated version of the reference's manual e2e path
(single_frame_experiment + render_surgery + validation_reporting).
"""

import json
from pathlib import Path

import numpy as np
import pytest

from omfs4d.core.config import Config
from omfs4d.io.synthetic import make_synthetic_dataset
from omfs4d.pipeline.runner import Pipeline


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("e2e")
    out = make_synthetic_dataset(root / "data", n_frames=56, width=64,
                                 height=64, n_vertices=700, backend="never")
    return root, out


@pytest.mark.slow
def test_full_pipeline_e2e(synth):
    root, synth_out = synth
    data_dir = synth_out["path"]

    cfg = Config()
    cfg.train.iterations = 80
    cfg.train.densify_interval = 0
    cfg.train.opacity_reset_interval = 0
    cfg.train.max_gaussians = 2048
    cfg.render.max_per_tile = 128
    cfg.render.use_pallas = "never"
    cfg.predict.deterministic_max_frames = 8

    pipe = Pipeline(cfg, root / "work")
    # the pipeline's model must match the dataset's synthetic head
    pipe.model = synth_out["model"]

    model_dir = pipe.train(data_dir, root / "model")
    assert (model_dir / "point_cloud" / "iteration_80").exists()
    manifests = list((model_dir / "experiment_manifests").glob("*.json"))
    assert manifests, "experiment manifest missing"
    payload = json.loads(manifests[0].read_text())
    assert payload["dataset_fingerprint"]["dataset_hash"]

    det_dir = root / "det"
    result = pipe.render_surgery(
        model_dir, data_dir, root / "pred.mp4",
        lefort_mm=5.0, bsso_mm=3.0,
        export_frames_dir=str(det_dir),
    )
    assert Path(result["video"]).exists()
    assert result["iteration"] == 80
    assert abs(result["lefort_offset"] - 0.005) < 1e-9
    renders = list(Path(result["renders_dir"]).glob("*.png"))
    assert len(renders) > 0

    report = pipe.report(model_dir, det_dir)
    assert report["summary"]["count"] > 0
    scores = model_dir / "eval_strict" / "reports" / "strict_scores.json"
    assert scores.exists()


@pytest.mark.slow
def test_surgery_actually_changes_pixels(synth):
    """A nonzero jaw advancement must change the rendered prediction."""
    root, synth_out = synth
    data_dir = synth_out["path"]
    model_dir = root / "model"
    if not (model_dir / "point_cloud").exists():
        pytest.skip("depends on test_full_pipeline_e2e")

    cfg = Config()
    cfg.render.max_per_tile = 128
    cfg.render.use_pallas = "never"
    pipe = Pipeline(cfg, root / "work2")
    pipe.model = synth_out["model"]

    r0 = pipe.render_surgery(model_dir, data_dir, root / "p0.mp4",
                             lefort_mm=0.0, bsso_mm=0.0,
                             keep_modified_dataset=False)
    from omfs4d.io.video import read_image
    f0 = read_image(sorted(Path(r0["renders_dir"]).glob("*.png"))[0])

    r1 = pipe.render_surgery(model_dir, data_dir, root / "p1.mp4",
                             lefort_mm=0.0, bsso_mm=80.0)
    f1 = read_image(sorted(Path(r1["renders_dir"]).glob("*.png"))[0])
    diff = np.abs(f0.astype(np.float32) - f1.astype(np.float32)).mean()
    assert diff > 0.05, diff


@pytest.mark.slow
def test_pipeline_track_produces_contract_dataset(synth, tmp_path):
    """frames dir -> landmarks -> staged tracking -> contract dataset."""
    import shutil
    from omfs4d.core.config import Config
    from omfs4d.io.dataset import FrameDataset
    from omfs4d.ops.camera import look_at_camera
    from omfs4d.pipeline.runner import Pipeline
    from omfs4d.track.landmarks import detect_landmarks, save_landmarks

    root, synth_out = synth
    src = synth_out["path"]

    # frames dir in the preprocess-stage layout
    frames_dir = tmp_path / "pre"
    (frames_dir / "images").mkdir(parents=True)
    for p in sorted((src / "images").glob("*.png"))[:8]:
        shutil.copy2(p, frames_dir / "images" / p.name)

    cam = look_at_camera(eye=(0, 0, 0.5), target=(0, 0, 0), fx=1.6 * 64,
                         width=64, height=64)
    # synthetic GT landmarks for the 8 frames
    params8 = {k: (v if k == "shape" else v[:8])
               for k, v in synth_out["params"].items()}
    lmk, valid = detect_landmarks(None, method="synthetic",
                                  model=synth_out["model"], params=params8,
                                  cameras=cam)
    save_landmarks(frames_dir / "images" / "landmarks.npz", lmk, valid)

    cfg = Config()
    cfg.track.n_shape = 20
    cfg.track.n_expr = 10
    cfg.track.steps_lmk_init_rigid = 25
    cfg.track.steps_lmk_init_all = 25
    cfg.track.steps_rgb_init_texture = 6
    cfg.track.steps_rgb_init_all = 6
    cfg.track.steps_rgb_init_offset = 2
    cfg.track.steps_rgb_sequential = 1
    cfg.track.steps_global = 8
    cfg.track.epochs_global = 1
    cfg.render.max_per_tile = 128
    cfg.render.use_pallas = "never"

    pipe = Pipeline(cfg, tmp_path / "work")
    pipe.model = synth_out["model"]
    out = pipe.track(frames_dir, cam, landmark_method="file")

    ds = FrameDataset(out, split="train")
    assert len(ds) >= 7
    assert ds.flame_params["shape"].shape == (300,)
    assert ds.flame_params["expr"].shape[1] == 100
    p0 = ds.load_frame_params(0)
    assert "jaw_pose" in p0 and "translation" in p0
    assert (out / "canonical_flame_param.npz").exists()
    assert (out / "points3d.ply").exists()


@pytest.mark.slow
def test_reference_layout_dataset_trains_and_predicts(tmp_path):
    """A dataset in the reference converter's exact layout (VHAP-style
    images/00000_00.png camera-suffixed names, per-frame npz, batched npz,
    canonical npz; ref preprocess_video.py:200-426) goes through
    train -> zero-offset surgical render and reconstructs the capture.

    This is the simulated 'reference-produced dataset' compatibility run:
    a user switching from the reference can point this framework at their
    existing tracked data."""
    import json
    import shutil
    from omfs4d.io.synthetic import make_synthetic_dataset
    from omfs4d.io.video import read_image
    from omfs4d.pipeline.runner import Pipeline
    from omfs4d.train.losses import psnr as psnr_fn

    S, T = 48, 5
    # n_vertices=5143: the reference contract pads offsets to full FLAME
    # size (preprocess_video.py:273-341), so a "reference-produced" dataset
    # always carries 5143-vert offset tensors
    case = make_synthetic_dataset(tmp_path / "case", n_frames=T,
                                  width=S, height=S, n_vertices=5143,
                                  backend="never")
    data_dir = case["path"]

    # morph to the reference converter's camera-suffixed naming
    for sub in ("images", "fg_masks"):
        d = data_dir / sub
        if d.is_dir():
            for p in sorted(d.glob("*.png")):
                p.rename(p.with_name(p.stem + "_00.png"))
    for tf in data_dir.glob("transforms_*.json"):
        meta = json.loads(tf.read_text())
        for fr in meta["frames"]:
            for key in ("file_path", "fg_mask_path"):
                if key in fr:
                    fr[key] = fr[key].replace(".png", "_00.png")
        tf.write_text(json.dumps(meta))

    cfg = Config()
    cfg.pipeline.min_train_frames = 2
    cfg.render.use_pallas = "never"
    cfg.render.max_per_tile = 128
    cfg.train.max_gaussians = 4096
    cfg.train.densify_interval = 0
    cfg.train.opacity_reset_interval = 0
    pipe = Pipeline(cfg, tmp_path / "wd")

    model_dir = pipe.train(data_dir, iterations=60)
    result = pipe.render_surgery(model_dir, data_dir, tmp_path / "self.mp4",
                                 0.0, 0.0)
    assert Path(result["video"]).exists()
    renders = sorted(Path(result["renders_dir"]).glob("*.png"))
    gts = sorted((Path(result["renders_dir"]).parent / "gt").glob("*.png"))
    # train split = 90% of frames
    assert len(renders) == len(gts) > 0
    import jax.numpy as jnp
    vals = [float(psnr_fn(jnp.asarray(read_image(r) / 255.0),
                          jnp.asarray(read_image(g) / 255.0)))
            for r, g in zip(renders, gts)]
    assert float(np.mean(vals)) > 13.0, vals


@pytest.mark.slow
def test_pipeline_gaussian_sharded_training(tmp_path):
    """parallel.n_gauss > 1 routes the train stage through the
    model-parallel ShardedAvatarTrainer (gaussians + Adam moments behind
    P('gauss')) and still produces the standard model artifacts that the
    prediction renderer consumes."""
    from omfs4d.io.synthetic import make_synthetic_dataset

    S, T = 48, 3
    case = make_synthetic_dataset(tmp_path / "case", n_frames=T,
                                  width=S, height=S, n_vertices=5143,
                                  backend="never")
    cfg = Config()
    cfg.pipeline.min_train_frames = 2
    cfg.render.use_pallas = "never"
    cfg.render.max_per_tile = 128
    cfg.train.max_gaussians = 4096
    cfg.train.densify_interval = 4
    cfg.train.densify_from = 2
    cfg.train.opacity_reset_interval = 0
    cfg.parallel.n_gauss = 4
    pipe = Pipeline(cfg, tmp_path / "wd")
    model_dir = pipe.train(case["path"], iterations=8)
    pc = model_dir / "point_cloud" / "iteration_8" / "point_cloud.ply"
    assert pc.exists()
    result = pipe.render_surgery(model_dir, case["path"],
                                 tmp_path / "pred.mp4", 2.0, 1.0)
    assert Path(result["video"]).exists()

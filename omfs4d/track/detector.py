"""Self-trained neural facial-landmark detector (JAX CNN).

The reference detects landmarks with external GPU models (MediaPipe 478-pt,
flame_fitter.py:200-240; face-alignment FAN via VHAP, preprocess_video.py:163)
— neither ships in this image.  This module provides a first-party detector:
a small strided-conv regressor trained by *domain-randomized self-supervision*
— the framework renders its own FLAME head (random identity/expression/pose/
camera/texture/background/photometrics) with the differentiable rasterizer
and supervises on the projected ground-truth landmark positions.  The whole
data generator + train step is one jitted device program; no files, no
labels.

Weights are cached as an .npz (flat name->array dict).  The detector is
registered as ``method="neural"`` in omfs4d.track.landmarks, alongside
gated ``mediapipe`` / ``face_alignment`` adapters for when those libraries
are importable.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from omfs4d.core.logging import get_logger
from omfs4d.models.flame import FlameModel, flame_forward, flame_landmarks
from omfs4d.ops.camera import Camera, project_points

log = get_logger("detector")

# strided conv stack: channels per stage (each halves the resolution),
# then two stride-1 trunk convs and a 1x1 heatmap head read out by a
# spatial softmax (soft-argmax).  A fully-convolutional localization head
# is translation-equivariant, so it cannot memorize absolute layouts the
# way a flattened FC regressor can (gated off-distribution in
# track/robustness.py + tests/test_detector.py).
_CHANNELS = (32, 64, 128)
_STRIDES = (2, 2, 2)   # feature grid = S/8 (a finer S/4 grid measured WORSE:
#                        the plateau is texture-randomization ambiguity, not
#                        heatmap pitch)
_TRUNK = (128, 128)


def default_cache_dir() -> Path:
    return Path(os.environ.get(
        "OMFS4D_CACHE", os.path.join(os.path.expanduser("~"), ".cache", "omfs4d")
    ))


# ── network ──────────────────────────────────────────────────


def _he_conv(key, kh, kw, c_in, c_out):
    fan_in = kh * kw * c_in
    return jax.random.normal(
        key, (kh, kw, c_in, c_out), jnp.float32) * np.sqrt(2.0 / fan_in)


def init_net(key, n_landmarks: int, image_size: int = 96) -> dict:
    """He-init parameters for the landmark localizer (flat dict pytree)."""
    params = {}
    c_in = 3
    for i, c_out in enumerate(_CHANNELS):
        key, k = jax.random.split(key)
        params[f"conv{i}/w"] = _he_conv(k, 3, 3, c_in, c_out)
        params[f"conv{i}/b"] = jnp.zeros((c_out,), jnp.float32)
        c_in = c_out
    for i, c_out in enumerate(_TRUNK):
        key, k = jax.random.split(key)
        params[f"trunk{i}/w"] = _he_conv(k, 3, 3, c_in, c_out)
        params[f"trunk{i}/b"] = jnp.zeros((c_out,), jnp.float32)
        c_in = c_out
    key, k = jax.random.split(key)
    params["head/w"] = _he_conv(k, 1, 1, c_in, n_landmarks) * 0.1
    params["head/b"] = jnp.zeros((n_landmarks,), jnp.float32)
    # per-landmark softmax sharpness (log-scale, learned)
    params["head/log_temp"] = jnp.zeros((n_landmarks,), jnp.float32)
    # train-time input size, carried with the weights so detect() can
    # resize inputs to the trained distribution (the net itself is fully
    # convolutional and size-agnostic)
    params["meta/size"] = jnp.asarray(float(image_size), jnp.float32)
    return params


def net_apply(params: dict, images: jnp.ndarray) -> jnp.ndarray:
    """(B, S, S, 3) float in [0,1] -> (B, L, 2) normalized landmark coords.

    Per-image standardization makes the features invariant to global
    gain/bias (photometric robustness by construction); the soft-argmax
    readout keeps localization translation-equivariant."""
    mu = jnp.mean(images, axis=(1, 2, 3), keepdims=True)
    sd = jnp.std(images, axis=(1, 2, 3), keepdims=True)
    x = (images - mu) / (sd + 1e-5)
    for i in range(len(_CHANNELS)):
        s = _STRIDES[i]
        x = jax.lax.conv_general_dilated(
            x, params[f"conv{i}/w"], (s, s), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        ) + params[f"conv{i}/b"]
        x = jax.nn.relu(x)
    for i in range(len(_TRUNK)):
        x = jax.lax.conv_general_dilated(
            x, params[f"trunk{i}/w"], (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        ) + params[f"trunk{i}/b"]
        x = jax.nn.relu(x)
    logits = jax.lax.conv_general_dilated(
        x, params["head/w"], (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
    ) + params["head/b"]                                  # (B, h, w, L)
    B, h, w, L = logits.shape
    temp = jnp.exp(params["head/log_temp"])
    flat = logits.reshape(B, h * w, L) * temp
    attn = jax.nn.softmax(flat, axis=1).reshape(B, h, w, L)
    # expected position over normalized cell centers
    ys = (jnp.arange(h, dtype=jnp.float32) + 0.5) / h
    xs = (jnp.arange(w, dtype=jnp.float32) + 0.5) / w
    ex = jnp.einsum("bhwl,w->bl", attn, xs)
    ey = jnp.einsum("bhwl,h->bl", attn, ys)
    return jnp.stack([ex, ey], axis=-1)                   # (B, L, 2) in [0,1]


def save_detector(path: str | Path, params: dict) -> None:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    np.savez(p, **{k: np.asarray(v) for k, v in params.items()})


def load_detector(path: str | Path) -> dict:
    data = np.load(Path(path))
    return {k: jnp.asarray(data[k]) for k in data.files}


# ── domain-randomized synthetic supervision ──────────────────


def _look_at_w2c(eye: jnp.ndarray, target: jnp.ndarray) -> jnp.ndarray:
    """Traceable OpenCV-convention look-at (mirrors ops.camera.look_at_camera)."""
    fwd = target - eye
    fwd = fwd / jnp.linalg.norm(fwd)
    up = jnp.array([0.0, 1.0, 0.0], jnp.float32)
    right = jnp.cross(fwd, up)
    right = right / jnp.linalg.norm(right)
    down = jnp.cross(fwd, right)
    R = jnp.stack([right, down, fwd], axis=0)
    w2c = jnp.eye(4, dtype=jnp.float32)
    w2c = w2c.at[:3, :3].set(R)
    return w2c.at[:3, 3].set(-R @ eye)


class SyntheticFaceSampler:
    """Jitted generator of (image, normalized-landmark) training pairs.

    Pre-builds a bank of differently-textured avatars on the FLAME mesh;
    each sample draws an avatar, FLAME params, a camera on a randomized
    orbit, a vertical-gradient background, and photometric jitter.
    """

    def __init__(self, model: FlameModel, image_size: int = 96,
                 n_textures: int = 4, max_per_tile: int = 128,
                 backend: str = "never"):
        from omfs4d.io.synthetic import textured_gt_avatar

        self.model = model
        self.size = int(image_size)
        self.backend = backend
        self.max_per_tile = max_per_tile
        bank = [textured_gt_avatar(model, seed=s) for s in range(n_textures)]
        self.avatars = jax.tree_util.tree_map(
            lambda *xs: jnp.stack(xs), *bank)
        faces_np = np.asarray(model.faces)
        self.face_centers = jnp.asarray(
            np.asarray(model.v_template)[faces_np].mean(axis=1), jnp.float32)
        self._batch_fn = {}  # keyed by batch_size

    def _sample_one(self, key, avatar) -> tuple[jnp.ndarray, jnp.ndarray]:
        from omfs4d.render.rasterize import render_avatar_frame

        model, S = self.model, self.size
        ks = jax.random.split(key, 12)

        params = {
            "shape": jnp.zeros((model.shapedirs_shape.shape[-1],), jnp.float32),
            "expr": 0.5 * jax.random.normal(
                ks[0], (1, model.shapedirs_expr.shape[-1])),
            "jaw_pose": jnp.concatenate([
                jax.random.uniform(ks[1], (1, 1), minval=0.0, maxval=0.35),
                0.05 * jax.random.normal(ks[2], (1, 2)),
            ], axis=1),
            "rotation": jnp.stack([
                jax.random.uniform(ks[3], (), minval=-0.3, maxval=0.3),
                jax.random.uniform(ks[4], (), minval=-0.6, maxval=0.6),
                jax.random.uniform(ks[5], (), minval=-0.2, maxval=0.2),
            ])[None],
            "translation": 0.02 * jax.random.normal(ks[6], (1, 3)),
        }
        verts = flame_forward(model, params)[0]

        ang = jax.random.uniform(ks[7], (), minval=-0.7, maxval=0.7)
        radius = jax.random.uniform(ks[8], (), minval=0.45, maxval=0.8)
        height = 0.12 * jax.random.normal(ks[9], ())
        eye = jnp.stack([radius * jnp.sin(ang), height, radius * jnp.cos(ang)])
        focal = S * jax.random.uniform(ks[10], (), minval=1.3, maxval=2.2)
        cam = Camera(
            w2c=_look_at_w2c(eye, jnp.zeros(3)),
            fx=focal, fy=focal,
            cx=jnp.float32(S / 2), cy=jnp.float32(S / 2),
            width=S, height=S,
        )

        # texture-family domain randomization + directional shading.  A net
        # trained on any FIXED texture family reads landmark positions off
        # the palette and transfers NOTHING (measured: on a held-out texture
        # family its error equals the predict-center baseline).  Drawing
        # every sample's texture from a broad procedural family — smooth
        # directional waves x per-face speckle x two-palette blotches in a
        # random convex mix — leaves geometry (silhouette + shading) as the
        # only reliable cue, which is exactly what transfers across texture
        # families and image formations (gated by tests/test_detector.py
        # via track/robustness.py).
        kt = jax.random.split(ks[11], 16)
        ctr = self.face_centers                          # (F, 3) canonical
        dirs = jax.random.normal(kt[0], (3, 3))
        dirs = dirs / (jnp.linalg.norm(dirs, axis=1, keepdims=True) + 1e-8)
        freq = jax.random.uniform(kt[1], (3,), minval=3.0, maxval=25.0)
        phase = jax.random.uniform(kt[2], (3,), minval=0.0,
                                   maxval=2 * jnp.pi)
        smooth = 0.5 + 0.35 * jnp.sin((ctr @ dirs.T) * freq + phase)
        speckle = jax.random.uniform(kt[3], (ctr.shape[0], 3))
        d2 = jax.random.normal(kt[4], (3,))
        d2 = d2 / (jnp.linalg.norm(d2) + 1e-8)
        field = jnp.sin(
            (ctr @ d2) * jax.random.uniform(kt[5], (), minval=3.0,
                                            maxval=15.0)
            + jax.random.uniform(kt[6], (), minval=0.0, maxval=2 * jnp.pi))
        pal = jax.random.uniform(kt[7], (2, 3))
        blotch = jnp.where(field[:, None] > 0.0, pal[0], pal[1])
        w = jax.random.uniform(kt[8], (3,), minval=0.05, maxval=1.0)
        w = w / w.sum()
        cols = w[0] * smooth + w[1] * speckle + w[2] * blotch   # (F, 3)

        # directional lambertian shading on the DEFORMED face normals:
        # interior geometry (brow/nose/chin curvature) that survives any
        # texture and exists in every real image formation.  |n.l| — face
        # winding is not guaranteed outward.
        fv = verts[model.faces]                          # (F, 3, 3)
        nrm = jnp.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
        nrm = nrm / (jnp.linalg.norm(nrm, axis=1, keepdims=True) + 1e-8)
        ldir = jax.random.normal(kt[9], (3,))
        ldir = ldir / (jnp.linalg.norm(ldir) + 1e-8)
        amb = jax.random.uniform(kt[10], (), minval=0.35, maxval=0.75)
        dif = jax.random.uniform(kt[11], (), minval=0.25, maxval=0.65)
        lam = amb + dif * jnp.abs(nrm @ ldir)            # (F,)
        # MIXED distribution: half the samples keep the bank texture
        # (sharp, learnable landmark detail -> in-dist precision), half get
        # the randomized family (texture cannot be load-bearing ->
        # robustness).  Both are always shaded.
        bank_cols = jax.nn.sigmoid(
            avatar.color * jax.random.uniform(kt[13], (), minval=0.7,
                                              maxval=1.3))
        use_bank = jax.random.bernoulli(kt[14], 0.5)
        mixed = jnp.where(use_bank, bank_cols, cols[avatar.parent_face])
        shaded = jnp.clip(mixed * lam[avatar.parent_face][:, None],
                          0.02, 0.98)
        avatar = avatar._replace(color=jnp.log(shaded / (1.0 - shaded)))

        img, aux = render_avatar_frame(
            avatar, verts, model.faces, cam, S, S,
            background=jnp.zeros(3), max_per_tile=self.max_per_tile,
            backend=self.backend,
        )
        # randomized background: linear gradient along a random direction,
        # or near-solid with sensor noise
        kb = jax.random.split(kt[15], 10)
        c_a = jax.random.uniform(kb[0], (3,))
        c_b = jax.random.uniform(kb[1], (3,))
        theta = jax.random.uniform(kb[2], (), minval=0.0, maxval=2 * jnp.pi)
        yy = jnp.linspace(-0.5, 0.5, S)[:, None]
        xx = jnp.linspace(-0.5, 0.5, S)[None, :]
        t = (yy * jnp.sin(theta) + xx * jnp.cos(theta) + 0.5)[..., None]
        t = jnp.where(jax.random.bernoulli(kb[3], 0.25), 0.5, t)  # solid
        bg = c_a * (1 - t) + c_b * t
        alpha = aux["alpha"][..., None]
        img = img + (1.0 - alpha) * bg
        gain = jax.random.uniform(kb[4], (), minval=0.55, maxval=1.35)
        bias = jax.random.uniform(kb[5], (), minval=-0.1, maxval=0.15)
        img = jnp.clip(img * gain + bias
                       + 0.02 * jax.random.normal(kb[6], img.shape), 0, 1)

        # random separable gaussian blur (sigma up to ~1.2px, half the
        # samples): edge sharpness differs across image formations (splat
        # vs mesh raster vs real video), so it must not become a feature
        sig = jax.random.uniform(kb[8], (), minval=0.3, maxval=1.2)
        offs = jnp.arange(-2.0, 3.0)
        kern = jnp.exp(-0.5 * (offs / sig) ** 2)
        kern = kern / kern.sum()
        kern = jnp.where(jax.random.bernoulli(kb[9], 0.5), kern,
                         jnp.array([0.0, 0.0, 1.0, 0.0, 0.0]))

        def _depthwise(x, kh_kw, k):
            rhs = jnp.broadcast_to(k.reshape(kh_kw + (1, 1)), kh_kw + (1, 3))
            return jax.lax.conv_general_dilated(
                x, rhs, (1, 1), "SAME",
                dimension_numbers=("NHWC", "HWIO", "NHWC"),
                feature_group_count=3)

        img = _depthwise(_depthwise(img[None], (5, 1), kern),
                         (1, 5), kern)[0]

        # cutout: 0-2 random opaque boxes (occlusion robustness).  The
        # landmark labels stay put (regress-through-occlusion); the alpha
        # label is zeroed (an occluder hides the foreground from matting).
        alpha_lbl = aux["alpha"]
        for kc in jax.random.split(kb[7], 2):
            kc1, kc2, kc3, kc4 = jax.random.split(kc, 4)
            on = jax.random.bernoulli(kc1, 0.5)
            cyx = jax.random.uniform(kc2, (2,), minval=0.0, maxval=1.0) * S
            half = (jax.random.uniform(kc3, (2,), minval=0.06, maxval=0.16)
                    * S * jnp.where(on, 1.0, 0.0))
            box = ((jnp.abs(jnp.arange(S)[:, None] + 0.5 - cyx[0])
                    < half[0])
                   & (jnp.abs(jnp.arange(S)[None, :] + 0.5 - cyx[1])
                      < half[1]))
            img = jnp.where(box[..., None],
                            jax.random.uniform(kc4, (3,)), img)
            alpha_lbl = jnp.where(box, 0.0, alpha_lbl)

        lmk3d = flame_landmarks(model, verts[None])[0]
        lmk_uv, _ = project_points(cam, lmk3d)
        return img, lmk_uv / S, alpha_lbl

    def batch(self, key, batch_size: int):
        """(images (B,S,S,3), labels (B,L,2) normalized, alpha (B,S,S))
        — one jit call.  `alpha` is the ground-truth foreground coverage
        (used as matting supervision by track.segnet)."""
        if batch_size not in self._batch_fn:
            n_tex = jax.tree_util.tree_leaves(self.avatars)[0].shape[0]

            def gen(key):
                kt, ks = jax.random.split(key)
                tex_idx = jax.random.randint(kt, (batch_size,), 0, n_tex)
                avatars = jax.tree_util.tree_map(
                    lambda a: a[tex_idx], self.avatars)
                return jax.vmap(self._sample_one)(
                    jax.random.split(ks, batch_size), avatars)

            self._batch_fn[batch_size] = jax.jit(gen)
        return self._batch_fn[batch_size](key)


def train_detector(
    model: FlameModel,
    steps: int = 1500,
    batch_size: int = 32,
    image_size: int = 96,
    lr: float = 3e-4,
    seed: int = 0,
    backend: str = "never",
    log_every: int = 200,
) -> dict:
    """Train the regressor on domain-randomized synthetic renders."""
    import optax

    sampler = SyntheticFaceSampler(model, image_size, backend=backend)
    n_lmk = model.lmk_faces_idx.shape[0]
    key = jax.random.PRNGKey(seed)
    key, k_init = jax.random.split(key)
    params = init_net(k_init, n_lmk, image_size)

    opt = optax.adam(optax.cosine_decay_schedule(lr, steps, alpha=0.1))
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state, images, labels):
        def loss_fn(p):
            pred = net_apply(p, images)
            return jnp.mean(optax.huber_loss(pred, labels, delta=0.05))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state2 = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state2, loss

    for i in range(steps):
        key, kb = jax.random.split(key)
        images, labels, _ = sampler.batch(kb, batch_size)
        params, opt_state, loss = step(params, opt_state, images, labels)
        if log_every and (i % log_every == 0 or i == steps - 1):
            px = float(jnp.sqrt(loss * 2) * image_size)  # rough px scale
            log.info(f"detector step {i}: huber {float(loss):.5f} (~{px:.1f}px)")
    return params


def get_or_train_detector(
    model: FlameModel,
    weights: str | Path | None = None,
    image_size: int = 96,
    steps: int = 1500,
    backend: str = "never",
    seed: int = 0,
) -> dict:
    """Load cached weights keyed by (mesh, size, steps); train if absent."""
    if weights is not None and Path(weights).exists():
        return load_detector(weights)
    n_lmk = model.lmk_faces_idx.shape[0]
    # "sa2" = soft-argmax head trained on the texture-randomized + shaded
    # sampler; new name so caches from older training distributions are
    # never loaded
    cache = default_cache_dir() / (
        f"landmark_net_sa2_v{model.n_vertices}_l{n_lmk}_s{image_size}_t{steps}.npz"
    )
    if weights is None and cache.exists():
        log.info(f"loading cached detector weights: {cache}")
        return load_detector(cache)
    log.info(f"training landmark detector ({steps} steps @ {image_size}px)...")
    params = train_detector(model, steps=steps, image_size=image_size,
                            backend=backend, seed=seed)
    save_detector(Path(weights) if weights else cache, params)
    return params


def detect(
    params: dict,
    frames: np.ndarray,              # (T, H, W, 3) uint8 or float [0,1]
    image_size: int | None = None,
    chunk: int = 64,
) -> tuple[np.ndarray, np.ndarray]:
    """Run the detector over a frame stack -> ((T, L, 2) px coords, valid)."""
    T, H, W = frames.shape[:3]
    S = image_size or int(np.asarray(params["meta/size"]))

    @jax.jit
    def run(imgs):
        x = imgs.astype(jnp.float32)
        if frames.dtype == np.uint8:
            x = x / 255.0
        x = jax.image.resize(x, (x.shape[0], S, S, 3), "linear")
        uv = net_apply(params, x)
        return uv * jnp.array([W, H], jnp.float32)

    out = np.concatenate([
        np.asarray(run(jnp.asarray(frames[i:i + chunk])))
        for i in range(0, T, chunk)
    ])
    return out.astype(np.float32), np.ones(T, bool)

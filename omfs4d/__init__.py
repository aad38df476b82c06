"""omfs4d — 4D oral-maxillofacial-surgery planning & prediction framework in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of the
cwlachap/OMFS-4D-Video-Gen reference platform:

  * Clinical engine: CT/CBCT (DICOM / NIfTI) -> bone segmentation -> surface
    mesh -> virtual osteotomies (Le Fort I + bilateral BSSO) -> segment motion
    -> mesh export.                       (ref: 01_Clinical_Engine/)
  * Visual engine: monocular video -> landmarks -> staged FLAME tracking ->
    mesh-bound 3D Gaussian Splatting avatar training -> surgical-plan FLAME
    perturbation -> 4D post-op prediction video.  (ref: 02_Visual_Engine/)

Everything heavy runs on a `jax.sharding.Mesh` of NVIDIA GPUs: the
differentiable gaussian rasterizer composites in a Pallas (Triton) kernel,
FLAME LBS is batched products, frames are data-parallel, and the tile grid
is spatially sharded.  Scientific IO (DICOM, NIfTI, PLY, PNG) is
first-party.
"""

__version__ = "0.1.0"

"""Render configuration.

Mirrors every compile-time constant of the reference
(`src/Constants.h:4-18`) as a runtime config, with the
reference values as defaults. `compat="reference"` replicates the reference's
quirks bit-for-bit in semantics (see SURVEY.md §2.19); `compat="physical"`
fixes them (correct per-light shading, no /MAXBOUNCES normalization, correct
refraction ratio, uniform sphere sampling).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    # Reference: src/Constants.h:10-12
    nsamples: int = 20          # DEFAULT_NSAMPLES
    max_bounces: int = 6        # MAXBOUNCES
    shadow_rays: int = 10       # NB_ECH

    # Reference: src/Constants.h:15-16 (KD build params; our BVH
    # analogues — the reference uses 40 tris/leaf). The leaf width of 16
    # is not yet tuned for the per-ray walk on the GPU.
    bvh_leaf_size: int = 16
    bvh_max_depth: int = 64

    # Reference: src/Constants.h:18
    epsilon: float = 1e-5

    # Reference: main.cpp:52-53 default framebuffer
    width: int = 850
    height: int = 480

    # "reference" replicates quirks (lights[0] color, /6 normalization,
    # glass -0.6 fudge, bounce-scaled skybox, cube-sampled unit vectors,
    # mesh emission skipped); "physical" fixes them.
    compat: str = "reference"

    # RNG seed for the counter-based sampler.
    seed: int = 0

    # Rays per device-step batch (wavefront width). Pixels*samples are
    # processed in chunks of this size to bound device memory.
    rays_per_batch: int = 1 << 20

    # Record-replay custom VJP for trace(): the forward records per-bounce
    # discrete selections and the backward differentiates a selected-hit
    # replay (no candidate argmin / BVH walks / shadow search in bwd).
    # "off" = plain remat'd scan autodiff.
    custom_vjp: str = "on"

    def __post_init__(self):
        if self.max_bounces < 1:
            # the trace drivers unroll the final bounce out of the scan,
            # so zero bounces would still execute one (at b = -1)
            raise ValueError("max_bounces must be >= 1")
        if self.compat not in ("reference", "physical"):
            raise ValueError(f"unknown compat mode: {self.compat!r}")
        if self.custom_vjp not in ("on", "off"):
            raise ValueError(f"unknown custom_vjp mode: {self.custom_vjp!r}")

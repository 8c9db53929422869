"""Top-level render driver — the wavefront recast of the reference's
`ray_trace_from_camera` (its `main.cpp:200-263`).

The reference spawns one std::thread per scanline; here the whole
pixels x samples grid is a flat ray stream processed in jit-compiled
device batches (and, via tracer/dist, sharded over a device mesh). Samples
accumulate into a float film; per-pixel mean + gamma 1/2.2 + clamp
reproduce main.cpp:193-196 / 258-261.

Fast path: `render_pixels` jits ONE frame-chunk — a `lax.scan` over the
sample axis around the traced batch — so a CLI render pays one dispatch per
chunk, not one per (sample, chunk).

Recovery: pass `ckpt_dir` to render through a `TileManifest` — each tile's
(film_sum, samples_done) is checkpointed atomically, and a restarted render
re-renders only missing tiles (SURVEY.md §5 failure recovery; the image sum
is associative, so resume is exact).
"""

from __future__ import annotations

import functools

import jax
import numpy as np
import jax.numpy as jnp

from tracer.core import rng
from tracer.core.config import RenderConfig
from tracer.core.mathutils import gamma_correct
from tracer.render import integrator
from tracer.render.camera import Camera, generate_rays
from tracer.render.film import TileManifest


def _render_batch(scene, camera: Camera, cfg: RenderConfig, width: int,
                  height: int, pixel_ids, sample_idx, base_key):
    """Radiance for one sample of a batch of pixels. pixel_ids: [N] i32
    (flat y*width + x). Returns [N, 3] linear radiance."""
    keys = rng.ray_keys(base_key, pixel_ids)
    keys = rng.salted(keys, sample_idx)

    jkey = rng.salted(keys, rng.PIXEL_JITTER)
    jit_uv = rng.uniform(jkey, (2,))
    x = (pixel_ids % width).astype(jnp.float32)
    y = (pixel_ids // width).astype(jnp.float32)
    u = (x + jit_uv[:, 0]) / width
    v = (y + jit_uv[:, 1]) / height

    tkey = rng.salted(keys, rng.RAY_TIME)
    time = rng.uniform(tkey)

    o, d = generate_rays(camera, u, v)
    return integrator.trace(scene, cfg, o, d, time, keys)


render_batch = jax.jit(_render_batch,
                       static_argnames=("cfg", "width", "height"))


@functools.partial(jax.jit,
                   static_argnames=("cfg", "width", "height", "nsamples"))
def render_pixels(scene, camera: Camera, cfg: RenderConfig, width: int,
                  height: int, pixel_ids, nsamples: int, base_key):
    """SUM of `nsamples` sample passes for `pixel_ids` — one compiled frame
    chunk (divide by nsamples for the mean radiance). Accumulates inside a
    scan (a lax.map + sum would materialize the full [spp, N, 3] stack in
    device memory)."""
    def body(acc, s):
        rad = _render_batch(scene, camera, cfg, width, height, pixel_ids,
                            s, base_key)
        return acc + rad, None
    acc0 = jnp.zeros(pixel_ids.shape + (3,), jnp.float32)
    acc, _ = jax.lax.scan(body, acc0,
                          jnp.arange(nsamples, dtype=jnp.int32))
    return acc


def render(scene, camera: Camera, cfg: RenderConfig, width=None, height=None,
           nsamples=None, progress=False, ckpt_dir=None, tile=128,
           host=0, n_hosts=1):
    """Full-frame render -> float32 [H, W, 3] gamma-corrected image.

    With `ckpt_dir`, renders tile-by-tile with atomic per-tile checkpoints
    and resumes exactly: tiles already done (>= nsamples accumulated) are
    skipped; the final image is assembled from the tile store. Tile->host
    assignment is deterministic (tile % n_hosts == host).
    """
    width = width or cfg.width
    height = height or cfg.height
    nsamples = nsamples or cfg.nsamples
    base_key = jax.random.key(cfg.seed)  # typed key: scalar per-ray keys

    if ckpt_dir is not None:
        return _render_tiled(scene, camera, cfg, width, height, nsamples,
                             base_key, ckpt_dir, tile, host, n_hosts,
                             progress)

    n_pix = width * height
    # One static chunk shape: the last chunk's wrapped ids re-render a few
    # pixels, and their duplicate radiance is discarded below.
    chunk = min(cfg.rays_per_batch, n_pix)
    n_chunks = (n_pix + chunk - 1) // chunk
    ids = np.arange(n_chunks * chunk, dtype=np.int32) % n_pix

    film = np.zeros((n_pix, 3), np.float32)
    for c in range(n_chunks):
        pid = jnp.asarray(ids[c * chunk:(c + 1) * chunk])
        rad = np.asarray(render_pixels(scene, camera, cfg, width, height,
                                       pid, nsamples, base_key))
        lo = c * chunk
        n_real = min(chunk, n_pix - lo)
        film[lo:lo + n_real] = rad[:n_real]
        if progress:
            print(f"  chunk {c + 1}/{n_chunks}", flush=True)

    img = film / np.float32(nsamples)
    img = np.asarray(gamma_correct(jnp.asarray(img)))
    return np.clip(img, 0.0, 1.0).reshape(height, width, 3)


def _render_tiled(scene, camera, cfg, width, height, nsamples, base_key,
                  ckpt_dir, tile, host, n_hosts, progress):
    man = TileManifest(width, height, tile, ckpt_dir)
    mine = man.tiles_for_host(host, n_hosts)
    pad_n = tile * tile
    for t in mine:
        if man.done(t, nsamples):
            if progress:
                print(f"  tile {t}: already done, skipping", flush=True)
            continue
        pids = man.tile_pixels(t)
        n_real = pids.shape[0]
        # pad ragged edge tiles to one static shape (single jit cache entry)
        pid_pad = np.zeros(pad_n, np.int32)
        pid_pad[:n_real] = pids
        rad = np.asarray(render_pixels(scene, camera, cfg, width, height,
                                       jnp.asarray(pid_pad), nsamples,
                                       base_key))[:n_real]
        man.save_tile(t, rad, nsamples)
        if progress:
            print(f"  tile {t}: rendered {n_real} px", flush=True)
    return man.assemble(nsamples)


def render_image(scene, camera, cfg, path, **kw):
    """Render and write a PPM (and .png twin) like main.cpp:251-262."""
    from tracer.io.ppm import write_ppm, write_png
    img = render(scene, camera, cfg, **kw)
    if path.endswith(".png"):
        write_png(path, img)
    else:
        write_ppm(path, img)
    return img

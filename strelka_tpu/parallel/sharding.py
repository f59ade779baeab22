"""Multi-chip execution: pixel-row sharding over a jax.sharding.Mesh.

The reference has NO multi-GPU path (SURVEY.md §2.4) — this is the scaling
axis of this build: tile pixel rows across the cards of one host, keep
per-card accumulators local, and let the host gather the framebuffer. The
mesh is a flat list of devices: every card reaches every other alike.

The launch runs under jax.shard_map: each chip executes the COMPLETE
wavefront loop on its own horizontal band, with the band's global row offset
(jax.lax.axis_index) feeding the camera NDC and the Sobol seed so the image
is identical to the single-chip render. Crucially the Z-order pixel permute
and the per-bounce wavefront re-sort are band-local inside the shard body —
GSPMD would lower those global gathers to per-launch all-to-alls; shard_map
makes "no per-launch collectives" true by construction (asserted by a
compiled-HLO test on the 8-device CPU mesh).

Per-pixel Sobol seeding is GLOBAL (Morton code of absolute pixel coords), so
the sharded render matches the single-chip render bit-for-bit.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_render_mesh(devices: Optional[list] = None, axis_name: str = "rows") -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def shard_launch(make_launch, mesh: Mesh, axis_name: str = "rows"):
    """Shard a render launch over pixel rows with shard_map.

    make_launch(local_height, full_height) must return a function
    launch(scene, params, state, py_offset) -> (state, image) that renders a
    [local_height, W] band whose top row sits at global row py_offset; state
    arrays are band-local ([3, local_h, W] planar images / [local_h, W]
    counters), and the returned image is [local_h, W, 4].
    """
    nd = int(np.prod(mesh.devices.shape))
    repl = P()
    img_spec = P(None, axis_name)  # [3, H, W] planar
    cnt_spec = P(axis_name)  # [H, W] counters and [H, W, 4] output

    def spec_of(x):
        return img_spec if getattr(x, "ndim", 0) == 3 else cnt_spec

    jit_cache: dict = {}

    def _get_fn(scene, params, state, full_h: int, local_h: int):
        key = (full_h, state.accum.shape[2])
        if key in jit_cache:
            return jit_cache[key]
        launch = make_launch(local_h, full_h)

        def shard_body(scene, params, state):
            off = jax.lax.axis_index(axis_name).astype(jnp.uint32) * jnp.uint32(local_h)
            return launch(scene, params, state, off)

        state_specs = jax.tree.map(spec_of, state)
        fn = jax.jit(
            jax.shard_map(
                shard_body,
                mesh=mesh,
                in_specs=(
                    jax.tree.map(lambda _: repl, scene),
                    jax.tree.map(lambda _: repl, params),
                    state_specs,
                ),
                out_specs=(state_specs, cnt_spec),
                check_vma=False,
            ),
            donate_argnums=(2,),
        )
        jit_cache[key] = fn
        return fn

    def _place(scene, params, state):
        scene = jax.device_put(scene, NamedSharding(mesh, repl))
        params = jax.device_put(params, NamedSharding(mesh, repl))
        state = jax.tree.map(
            lambda x: jax.device_put(x, NamedSharding(mesh, spec_of(x))), state
        )
        return scene, params, state

    def _abstract(x):
        return jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=x.sharding)

    def wrapper(scene, params, state):
        full_h = state.accum.shape[1]
        if full_h % nd != 0:
            raise ValueError(f"height {full_h} not divisible by {nd} shards")
        local_h = full_h // nd
        fn = _get_fn(scene, params, state, full_h, local_h)
        placed = _place(scene, params, state)
        wrapper.last_args = jax.tree.map(_abstract, placed)
        wrapper.last_fn = fn
        return fn(*placed)

    def lower():
        """jax.stages.Lowered of the most recent launch (compiled-HLO
        introspection: the no-per-launch-collectives property is asserted by
        a test, not hoped)."""
        return wrapper.last_fn.lower(*wrapper.last_args)

    wrapper.lower = lower
    return wrapper


def num_devices() -> int:
    return jax.device_count()

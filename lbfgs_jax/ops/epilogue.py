"""Fused trial + correction-pair + Gram epilogue: a Pallas kernel on the
Triton route for NVIDIA GPUs.

After the line search accepts a step, one L-BFGS iteration needs

    x = xp + stp*d,  (fx, g) = f(x),  dg = g.d, gg = g.g, xx = x.x,
    s = stp*d,  y = g - gp,  S[end] <- s,  Y[end] <- y,
    SP = S @ [y, s, -g(, gp)],  YP = Y @ [y, s, -g(, gp)]

(reference ``src/core.rs:155-164`` and ``src/lbfgs.rs:640-656``).  XLA
composes this from an objective fusion, two ring-row
``dynamic_update_slice`` writes, an ``[n, 3]`` stack and two Gram
contractions, each re-reading the vectors.  The kernel streams
(xp, d, gp, S, Y) once and writes (x, g) and the ring row ``end`` in
place.

GPU blocks run in no set order, so every block writes its own row of
partial sums (``[nblocks, K]``: fx, dg, gg, xx, changed and the 2m Gram
columns) and one jnp pass sums them; under ``fx_wide`` the fx partials
reduce in the wide representation (``fused.obj_reduce``).  The ring slot
``end`` is an operand; (x, g, S, Y) alias (xp, gp, S, Y) through
``input_output_aliases``.  Blocks are ``ROWS`` rows of 128 lanes with a
row-masked tail.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import Array
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from . import fused

#: rows of 128 lanes per program (a power of two, as Triton requires)
ROWS = 16
NUM_WARPS = 4

#: below this length a kernel launch does not pay for itself, and the
#: vmapped small-problem batch (``batched.py``) keeps the jnp path so the
#: whole batch vectorizes
MIN_N = 1 << 14


def supported(x: Array, S: Array, *extras: Array) -> bool:
    """Trace-time gate: engage the kernel on a single GPU for lane-aligned
    f32 problems whose history is stored ``[m, n/128, 128]``."""
    n = x.shape[0]
    return (
        jax.default_backend() == "gpu"
        and jax.device_count() == 1
        and n >= MIN_N
        and n % fused.LANES == 0
        and S.ndim == 3
        and S.dtype in (jnp.float32, jnp.bfloat16)
        and all(a.dtype == jnp.float32 for a in (x, *extras))
    )


def _kernel(*refs, block_fn, nex, m, nrows, with_gp):
    (end_ref, stp_ref, xp_ref, d_ref, gp_ref), rest = refs[:5], refs[5:]
    ex_refs, (S_ref, Y_ref) = rest[:nex], rest[nex:nex + 2]
    xt_ref, g_ref, So_ref, Yo_ref, parts_ref = rest[nex + 2:]
    L = fused.LANES
    # every index is an explicit i32: the interpreter discharges the body
    # outside the 32-bit trace context, where a python int becomes i64
    i32 = jnp.int32
    i = pl.program_id(0).astype(i32)
    r0 = i * ROWS
    row = r0 + jax.lax.broadcasted_iota(jnp.int32, (ROWS, L), 0)
    col = jax.lax.broadcasted_iota(jnp.int32, (ROWS, L), 1)
    valid = row < nrows
    blk = (pl.ds(r0, ROWS), pl.ds(i32(0), L))

    def load(ref, *lead):
        return plgpu.load(ref.at[(*lead, *blk)], mask=valid, other=0.0)

    end = end_ref[0]
    stp = stp_ref[0]
    xp = load(xp_ref)
    d = load(d_ref)
    gp = load(gp_ref)
    x = xp + stp * d
    fx_elem, g = block_fn(x, row * L + col, *(load(r) for r in ex_refs))
    fx_elem = jnp.where(valid, fx_elem, 0.0)
    g = jnp.where(valid, g, 0.0)
    plgpu.store(xt_ref.at[blk], x, mask=valid)
    plgpu.store(g_ref.at[blk], g, mask=valid)

    # correction pair (s = stp*d exactly on the projection-free path),
    # written in place into ring row `end`
    s = stp * d
    y = g - gp
    plgpu.store(So_ref.at[(end, *blk)], s.astype(So_ref.dtype), mask=valid)
    plgpu.store(Yo_ref.at[(end, *blk)], y.astype(Yo_ref.dtype), mask=valid)

    vals = [
        jnp.sum(fx_elem), jnp.sum(g * d), jnp.sum(g * g), jnp.sum(x * x),
        jnp.sum((x != xp).astype(jnp.float32)),
    ]
    basis = [y, s, -g] + ([gp] if with_gp else [])
    for H_ref, fresh in ((S_ref, s), (Y_ref, y)):
        for j in range(m):  # m is small and static: unrolled
            Hj = jnp.where(j == end, fresh,
                           load(H_ref, i32(j)).astype(jnp.float32))
            vals.extend(jnp.sum(Hj * z) for z in basis)
    for c, v in enumerate(vals):
        parts_ref[i, i32(c)] = v


def trial_pair_gram(block_fn, extras, xp, d, gp, stp, S, Y, end,
                    with_gp: bool = False, interpret: bool = False):
    """One-pass epilogue; ``S``/``Y`` are the ``[m, n/128, 128]`` history
    stacks, donated and updated in place at ring row ``end``.

    Returns ``(xt, fx, g, dg, gg, xx, changed, S_new, Y_new, SP, YP)`` with
    ``SP``/``YP`` of shape ``[m, 3]`` (``[m, 4]`` with the damped update's
    extra ``. gp`` column when ``with_gp``)."""
    n = xp.shape[0]
    m, nrows, L = S.shape
    if n % L or nrows * L != n:
        raise ValueError(f"history {S.shape} does not match n={n}")
    nc = 4 if with_gp else 3
    nb = pl.cdiv(nrows, ROWS)
    K = 5 + 2 * m * nc
    as2 = lambda v: v.reshape(nrows, L)
    vec = jax.ShapeDtypeStruct((nrows, L), xp.dtype)
    nex = len(extras)
    call = pl.pallas_call(
        functools.partial(_kernel, block_fn=block_fn, nex=nex, m=m,
                          nrows=nrows, with_gp=with_gp),
        grid=(nb,),
        out_shape=(vec, vec, jax.ShapeDtypeStruct(S.shape, S.dtype),
                   jax.ShapeDtypeStruct(Y.shape, Y.dtype),
                   jax.ShapeDtypeStruct((nb, K), jnp.float32)),
        # xp -> xt, gp -> g, S -> S_new, Y -> Y_new: the while-loop carry
        # buffers are reused instead of copied every iteration
        input_output_aliases={2: 0, 4: 1, 5 + nex: 2, 6 + nex: 3},
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="lbfgs_trial_pair_gram",
    )
    operands = (
        jnp.asarray(end, jnp.int32).reshape(1),
        jnp.asarray(stp, xp.dtype).reshape(1),
        as2(xp), as2(d), as2(gp), *(as2(e) for e in extras), S, Y,
    )
    # the body is f32/i32 by design: trace it in 32-bit mode so python
    # literals do not promote to 64-bit under jax_enable_x64 (the fx_wide
    # configuration); the wide reduction happens outside
    with jax.enable_x64(False):
        xt, g, S_new, Y_new, parts = call(*operands)
    tot = jnp.sum(parts, axis=0)
    fx = (fused.obj_reduce(parts[:, 0], xp.dtype)
          if fused.wide_fx_active() else tot[0])
    gram = tot[5:].reshape(2, m, nc)
    return (xt.reshape(-1), fx, g.reshape(-1), tot[1], tot[2], tot[3],
            tot[4] > 0.0, S_new, Y_new, gram[0], gram[1])


def trial_pair_gram_ref(value_and_grad, xp, d, gp, stp, S, Y, end,
                        with_gp: bool = False):
    """jnp oracle of ``trial_pair_gram`` (same outputs, history in any
    storage shape): a plain trial, the pair written into ring row
    ``end``, and the Gram products at "highest" precision (the fresh row
    enters unrounded, as in the kernel)."""
    from . import vecmath as vm

    xt = xp + stp * d
    fx, g = value_and_grad(xt)
    s, y = stp * d, g - gp
    m = S.shape[0]
    Z = jnp.stack([y, s, -g] + ([gp] if with_gp else []), axis=1)

    def ring(H, row):
        return H.reshape(m, -1).at[end].set(row.astype(H.dtype))

    SP = jnp.matmul(ring(S.astype(xp.dtype), s), Z, precision="highest")
    YP = jnp.matmul(ring(Y.astype(xp.dtype), y), Z, precision="highest")
    S_new = ring(S, s).reshape(S.shape)
    Y_new = ring(Y, y).reshape(Y.shape)
    return (xt, fx, g, vm.dot(g, d), vm.dot(g, g), vm.dot(xt, xt),
            jnp.any(xt != xp), S_new, Y_new, SP, YP)

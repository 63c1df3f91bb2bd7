"""The port's limited-context training attention against the JAX package on
the CPU, at a tiny width (64 d, 4 heads, dk 16).

Two paths of the port are held against their JAX counterparts on the same
weights and numpy inputs, at the four (c, L, R, b, t, lens) cases of
``tests/test_pallas_train_attention.py`` (the TPU kernel's g = 8, 4, 2, 1,
with R = 0 and L = 0):
- ``chunked_train``, the kernels' wrapper (on a CPU tensor: the plain forward
  and the plain backward of ``ops/chunk_attention_train.py``), against
  ``attention_chunked_train_pallas`` with the Pallas kernels in interpret mode;
- ``attention_chunked_train``, the plain oracle (unfold + rel_shift + masked
  softmax), against the JAX ``attention_chunked_train``.
ctx within f32 atol 1e-5; gradients of x and of every attention parameter
within atol 1e-4, rtol 1e-5 (the JAX test's own bar). Also: the CPU wrappers
launch nothing, their hand-written backward equals autograd at p > 0, and
dropout keeps about 1 - p of the attention weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chunkformer_tpu.nn.attention import (attention_chunked_train,
                                          attention_chunked_train_pallas,
                                          init_rel_attention)
from chunkformer_tpu.nn.embedding import rel_pos_slice
from chunkformer_tpu.ops.masks import make_non_pad_mask
from chunkformer_tpu_torch.nn.attention import RelPositionMultiHeadedAttention
from chunkformer_tpu_torch.ops import chunk_attention_train as cat

HEADS, D = 4, 64
CASES = [
    (8, 16, 16, 3, 60, [60, 37, 12]),   # n=8 -> g=8
    (8, 16, 16, 2, 30, [30, 17]),       # n=4 -> g=4
    (8, 16, 0, 2, 44, [44, 9]),         # n=6 -> g=2, R=0
    (8, 0, 8, 1, 21, [21]),             # n=3 -> g=1, L=0
]
_LINEARS = (("linear_q", "q"), ("linear_k", "k"), ("linear_v", "v"),
            ("linear_out", "out"), ("linear_pos", "pos"))


def _port_module(p):
    m = RelPositionMultiHeadedAttention(D, HEADS)
    with torch.no_grad():
        for name, key in _LINEARS:
            getattr(m, name).weight.copy_(torch.from_numpy(np.array(p[key]["w"]).T))
            if "b" in p[key]:
                getattr(m, name).bias.copy_(torch.from_numpy(np.asarray(p[key]["b"])))
        m.pos_bias_u.copy_(torch.from_numpy(np.asarray(p["pos_bias_u"])))
        m.pos_bias_v.copy_(torch.from_numpy(np.asarray(p["pos_bias_v"])))
    return m


def _port_grads(m):
    g = {key: {"w": m.get_parameter(f"{name}.weight").grad.numpy().T}
         for name, key in _LINEARS}
    for name, key in _LINEARS[:4]:
        g[key]["b"] = m.get_parameter(f"{name}.bias").grad.numpy()
    g["pos_bias_u"] = m.pos_bias_u.grad.numpy()
    g["pos_bias_v"] = m.pos_bias_v.grad.numpy()
    return g


@pytest.mark.parametrize("path", ["kernel_wrapper", "plain_oracle"])
@pytest.mark.parametrize("c,L,R,b,t,lens", CASES)
def test_train_attention_matches_jax(path, c, L, R, b, t, lens):
    p = jax.tree.map(np.asarray, init_rel_attention(jax.random.PRNGKey(c + L + R), D, HEADS))
    x = np.random.default_rng(1).normal(size=(b, t, D)).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    pos_emb = rel_pos_slice(D, c, L, R, 5000)
    w = jnp.cos(jnp.arange(D, dtype=jnp.float32))  # every output column matters

    if path == "kernel_wrapper":
        def f_jax(p, x):
            return attention_chunked_train_pallas(p, x, jnp.asarray(pos_emb), jnp.asarray(lens),
                                                  c, L, R, HEADS, interpret=True)
    else:
        pad_mask = make_non_pad_mask(jnp.asarray(lens), t)

        def f_jax(p, x):
            return attention_chunked_train(p, x, jnp.asarray(pos_emb), pad_mask, c, L, R, HEADS)

    @jax.jit
    def value_and_grads(p, x):
        out, vjp = jax.vjp(f_jax, p, x)
        return out, vjp(jnp.broadcast_to(w, out.shape))

    want, (want_gp, want_gx) = value_and_grads(p, jnp.asarray(x))

    m = _port_module(p)
    xt = torch.from_numpy(x).requires_grad_()
    fn = m.chunked_train if path == "kernel_wrapper" else m.attention_chunked_train
    launches = (cat.chunk_train_attention.fwd_launches, cat.chunk_train_attention.bwd_launches)
    got = fn(xt, torch.from_numpy(pos_emb), torch.from_numpy(lens), c, L, R)
    (got * torch.from_numpy(np.asarray(w))).sum().backward()
    assert launches == (cat.chunk_train_attention.fwd_launches,
                        cat.chunk_train_attention.bwd_launches)

    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_gx), atol=1e-4, rtol=1e-5)
    jax.tree.map(lambda a, e: np.testing.assert_allclose(a, np.asarray(e), atol=1e-4, rtol=1e-5),
                 _port_grads(m), want_gp)


def _operands(seed, b=2, n=3, c=8, L=16, R=8, heads=4, d_k=16):
    rng = np.random.default_rng(seed)
    tp = n * c
    kv = rng.normal(size=(b, L + tp + R, heads, 2 * d_k)).astype(np.float32)
    kv[:, :L] = 0.0
    kv[:, L + tp:] = 0.0
    arrs = [rng.normal(size=(b, tp, heads, d_k)), kv, rng.normal(size=(2 * c - 1 + L + R,
                                                                      heads, d_k)),
            rng.normal(size=(heads, d_k)), rng.normal(size=(heads, d_k))]
    ops = [torch.from_numpy(np.asarray(a, np.float32)) for a in arrs]
    return ops, torch.tensor([tp - 3, c + 5][:b], dtype=torch.int32), (c, L, R)


@pytest.mark.parametrize("drop", [0.0, 0.2])
def test_wrapper_backward_equals_autograd_of_plain_forward(drop):
    """The hand-written backward (the kernels' arithmetic, run by the CPU
    wrapper) against autograd through the plain forward, same dropout masks:
    f32 summation order only (atol 1e-5)."""
    ops, lens, (c, L, R) = _operands(3)
    wt = torch.from_numpy(np.random.default_rng(4).normal(size=ops[0].shape).astype(np.float32))
    grads = []
    for via_op in (True, False):
        leaves = [a.clone().requires_grad_() for a in ops]
        if via_op:
            out = cat.chunk_train_attention(*leaves, lens, 77, chunk=c, left=L, right=R,
                                            drop_rate=drop)
        else:
            out = cat.forward_plain(*leaves, lens, 77, c, L, R, drop)[0]
        grads.append(torch.autograd.grad((out * wt).sum(), leaves))
    for name, a, e in zip(("q", "kv", "p", "u", "v"), *grads):
        torch.testing.assert_close(a, e, atol=1e-5, rtol=1e-5, msg=name)


def test_cpu_dropout_keeps_one_minus_p():
    """On CPU tensors the wrapper runs the plain version and launches nothing;
    with every value row's first column 1, ctx[..., 0] * (1 - p) is the kept
    share of a query row's softmax weights: about 1 - p on average, 1 at p = 0.
    Masks depend on the seed and on nothing else."""
    ops, lens, (c, L, R) = _operands(5, b=2, n=6, c=16, L=32, R=16)
    ops[1][..., 16] = 1.0                                  # first value column
    ops[1][:, :L] = 0.0
    ops[1][:, L + 6 * 16:] = 0.0
    launches = (cat.chunk_train_attention.fwd_launches, cat.chunk_train_attention.bwd_launches)
    p = 0.3
    with torch.no_grad():
        full = cat.chunk_train_attention(*ops, lens, 11, chunk=c, left=L, right=R)
        kept = cat.chunk_train_attention(*ops, lens, 11, chunk=c, left=L, right=R, drop_rate=p)
        again = cat.chunk_train_attention(*ops, lens, 11, chunk=c, left=L, right=R,
                                          drop_rate=p)
        other = cat.chunk_train_attention(*ops, lens, 12, chunk=c, left=L, right=R,
                                          drop_rate=p)
    assert launches == (cat.chunk_train_attention.fwd_launches,
                        cat.chunk_train_attention.bwd_launches)
    valid = torch.arange(6 * 16)[None, :] < lens[:, None]
    torch.testing.assert_close(full[..., 0][valid], torch.ones_like(full[..., 0][valid]))
    share = float((kept[..., 0][valid] * (1 - p)).mean())
    assert abs(share - (1 - p)) < 0.02, share
    assert torch.equal(kept, again) and not torch.equal(kept, other)
    keep = cat.window_keep_mask(11, lens, 6, 4, c, L + c + R, p)
    assert abs(float(keep.float().mean()) - (1 - p)) < 0.01

"""The port's transformer against the flax model, on the same weights
(mapped with ``params_from_jax``) and the same numpy tokens: logits,
chunked loss and gradients in float32 (rtol 1e-4, atol 1e-5 — same math,
different summation order), logits in bfloat16 (2e-2), and one AdamW step
against ``optax.adamw(3e-4)`` on the same gradients (rtol 1e-6)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchft_tpu.models import transformer as jt
from torchft_tpu_torch.models import transformer as tt
from torchft_tpu_torch.optim import init_adam_state

pytestmark = pytest.mark.port


def _pair(kv_heads, jdtype, tdtype, layers=2):
    jcfg = jt.tiny_config(dtype=jdtype, num_kv_heads=kv_heads,
                          num_layers=layers)
    tcfg = tt.tiny_config(dtype=tdtype, num_kv_heads=kv_heads,
                          num_layers=layers)
    tokens = np.random.default_rng(0).integers(0, 256, (2, 48)).astype(
        np.int32)
    jm = jt.Transformer(jcfg)
    params = jm.init(jax.random.key(0), jnp.asarray(tokens))
    np_params = jax.tree_util.tree_map(np.asarray, params)
    tm = tt.Transformer(tcfg, device="cpu")
    tm.load_state_dict(tt.params_from_jax(np_params), strict=True)
    return jm, params, tm, tokens


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / (np.abs(np.asarray(b)).max() + 1e-30))


@pytest.mark.parametrize("kv_heads", [None, 2])
def test_f32_logits_loss_and_grads(kv_heads):
    jm, params, tm, tokens = _pair(kv_heads, jnp.float32, torch.float32)
    np.testing.assert_allclose(
        tm(torch.tensor(tokens)).detach().numpy(),
        np.asarray(jm.apply(params, jnp.asarray(tokens))),
        rtol=1e-4, atol=1e-5)

    def jloss(p):
        h = jm.apply(p, jnp.asarray(tokens), return_hidden=True)
        return jt.chunked_causal_lm_loss(
            h, p["params"]["lm_head"]["kernel"], jnp.asarray(tokens),
            chunk_size=16)

    jv, jg = jax.value_and_grad(jloss)(params)
    tv = tt.chunked_causal_lm_loss(tm(torch.tensor(tokens),
                                      return_hidden=True),
                                   tm.lm_head_kernel(),
                                   torch.tensor(tokens), chunk_size=16)
    tv.backward()
    np.testing.assert_allclose(float(tv.detach()), float(jv), rtol=1e-5)
    want = tt.params_from_jax(jax.tree_util.tree_map(np.asarray, jg))
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_bf16_logits():
    jm, params, tm, tokens = _pair(None, jnp.bfloat16, torch.bfloat16)
    got = tm(torch.tensor(tokens)).detach().numpy()
    want = np.asarray(jm.apply(params, jnp.asarray(tokens)), np.float32)
    assert got.dtype == np.float32  # the f32 LM head
    assert _rel(got, want) <= 2e-2


def test_params_from_jax_layouts():
    _, params, tm, _ = _pair(2, jnp.float32, torch.float32, layers=1)
    p = params["params"]["layer_0"]["attn"]
    sd = tm.state_dict()
    e, h, d = p["q"]["kernel"].shape
    assert sd["layers.0.attn.q.weight"].shape == (h * d, e)
    assert sd["layers.0.attn.k.weight"].shape == (2 * d, e)
    assert sd["layers.0.attn.o.weight"].shape == (e, h * d)
    assert sd["lm_head"].shape == params["params"]["lm_head"]["kernel"].shape
    assert sd["embed"].shape == params["params"]["embed"]["embedding"].shape


def test_adamw_step_matches_optax():
    """torch.optim.AdamW(lr=3e-4, weight_decay=1e-4, eps=1e-8) — the
    hyperparameters train_lm passes — against optax.adamw(3e-4) (whose
    weight decay defaults to 1e-4), three steps on the same gradients."""
    rng = np.random.default_rng(0)
    p0 = {"w": rng.standard_normal((16, 8)).astype(np.float32),
          "b": rng.standard_normal((8,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(3)]
    tx = optax.adamw(3e-4)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    st = tx.init(jp)
    for g in grads:
        upd, st = tx.update(jax.tree_util.tree_map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, upd)
    tp = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in p0.items()}
    opt = torch.optim.AdamW(tp.values(), lr=3e-4, weight_decay=1e-4,
                            eps=1e-8)
    init_adam_state(opt)
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.tensor(g[k])
        opt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(),
                                   np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


def test_cuda_default_device_raises_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tt.Transformer(tt.tiny_config())

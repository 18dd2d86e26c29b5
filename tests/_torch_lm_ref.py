"""The reference's dense-LM runs outside a mesh, for the port's LM mesh
tests (``test_torch_lm_fsdp.py``, ``test_torch_lm_multipod.py``): the
qwen2-1.5b smoke config cut to 2 layers (d 64, 4 heads over 2 KV heads,
d_ff 128, vocab 256, bf16), its params drawn by the reference with the
QKV biases and norm gains perturbed (as ``test_torch_lm.py``) and bridged
to the port, and each reference function under ``jax.jit``.
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np

from repro.configs.base import smoke_variant as jsmoke
from repro.configs.registry import get_config as jget
from repro.launch import steps as jsteps
from repro.models import api as japi

from repro_torch import bridge
from repro_torch.configs.base import smoke_variant as tsmoke
from repro_torch.configs.registry import get_config as tget
from repro_torch.optim.adamw import tree_leaves

BF16 = ml_dtypes.bfloat16


def corr(a, b) -> float:
    return float(np.corrcoef(np.ravel(a), np.ravel(b))[0, 1])


def rel_l2(a: dict, b: dict) -> float:
    """Relative L2 of tree ``a`` against tree ``b``, in float64."""
    la, lb = tree_leaves(a), tree_leaves(b)
    num = sum(float(((np.asarray(x, np.float64) - np.asarray(y, np.float64))
                     ** 2).sum()) for x, y in zip(la, lb))
    den = sum(float((np.asarray(y, np.float64) ** 2).sum()) for y in lb)
    return (num / den) ** 0.5


def argmax_outside_ties(got: np.ndarray, want: np.ndarray) -> float:
    """The share of positions (over the last axis) where ``got``'s argmax
    differs from ``want``'s, counting only those where ``want``'s top two
    logits are more than 1 bf16 ulp of the top apart: a closer pair is a
    tie that bf16 rounding order decides (the port's unsharded forward
    flips such pairs against the reference's scanned one too)."""
    top2 = np.sort(want, -1)[..., -2:]
    ulp = 2.0 ** (np.floor(np.log2(np.abs(top2[..., 1]) + 1e-30)) - 7)
    clear = top2[..., 1] - top2[..., 0] > ulp
    return float((got.argmax(-1) != want.argmax(-1))[clear].mean())


def smoke_model(n_layers: int = 2, seed: int = 0):
    """(reference cfg, port cfg, reference params (jnp), port params, numpy
    generator for the inputs)."""
    jcfg = jsmoke(jget("qwen2-1.5b")).with_(n_layers=n_layers)
    tcfg = tsmoke(tget("qwen2-1.5b")).with_(n_layers=n_layers)
    tree = jax.tree_util.tree_map(
        np.asarray, japi.init_model(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    attn = tree["blocks"]["attn"]
    for k in ("bq", "bk", "bv"):
        attn[k] = (rng.standard_normal(attn[k].shape) * 0.5).astype(BF16)
    for k in ("ln1", "ln2"):
        tree["blocks"][k] = (1.0 + 0.1 * rng.standard_normal(
            tree["blocks"][k].shape)).astype(BF16)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    return jcfg, tcfg, jp, bridge.from_jax_params(tree, "cpu"), rng


def reference_runs(jcfg, jp, prompt: np.ndarray, forced: np.ndarray,
                   batch: dict, cache_len: int) -> dict:
    """The reference outside a mesh: ``prefill_fn`` logits of the prompt;
    the teacher-forced ``decode_fn`` logits (the prompt stepped through
    the decode, then ``forced``), from the prompt's last position on;
    ``loss_fn`` and its gradient on ``batch``; one ``make_train_fn`` step's
    loss and clip norm. All f32 numpy."""
    b, p = prompt.shape
    out = {"prefill": np.asarray(jax.jit(lambda q, t: japi.prefill_fn(
        q, {"tokens": t}, jcfg))(jp, jnp.asarray(prompt)).astype(
            jnp.float32))}
    cache = {k: jnp.zeros(s, d) for k, (s, d) in
             japi.cache_axes_spec(jcfg, b, cache_len)[0].items()}
    decode = jax.jit(lambda q, c, t, pos: japi.decode_fn(q, c, t, pos, jcfg))
    dec = []
    for pos in range(p + forced.shape[1]):
        tok = (prompt[:, pos:pos + 1] if pos < p
               else forced[:, pos - p:pos - p + 1])
        lg, cache = decode(jp, cache, jnp.asarray(tok), jnp.int32(pos))
        if pos >= p - 1:
            dec.append(np.asarray(lg.astype(jnp.float32)))
    out["decode"] = np.stack(dec, 1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    loss, g = jax.jit(jax.value_and_grad(
        lambda q, bt: japi.loss_fn(q, bt, jcfg)))(jp, jb)
    out["loss"] = float(loss)
    out["grads"] = jax.tree_util.tree_map(
        lambda x: np.asarray(x.astype(jnp.float32)), g)
    st = {"params": jp, "opt": jax.tree_util.tree_map(
        jnp.asarray, jsteps.adamw_init(jp, jsteps.AdamWConfig(
            low_mem=True))), "step": jnp.zeros((), jnp.int32)}
    _, m = jax.jit(jsteps.make_train_fn(jcfg))(st, jb)
    out["step_loss"] = float(m["loss"])
    out["grad_norm"] = float(m["grad_norm"])
    return out


def unsharded_runs(tcfg, tp: dict, prompt: np.ndarray, forced: np.ndarray,
                   cache_len: int) -> dict:
    """The port outside a mesh on the CPU: ``prefill_fn`` and the
    teacher-forced decode logits, as ``reference_runs`` gives them."""
    import torch

    from repro_torch.launch import serve
    from repro_torch.models import api

    b = prompt.shape[0]
    with torch.no_grad():
        pre = api.prefill_fn(tp, {"tokens": torch.from_numpy(prompt)}, tcfg)
        cache = serve.init_cache(tcfg, b, cache_len, "cpu")
        lg, cache = serve.prefill_into_cache(tp, cache,
                                             torch.from_numpy(prompt), tcfg)
        lgs = [lg]
        for t in range(forced.shape[1]):
            lg, cache = api.decode_fn(tp, cache, torch.from_numpy(
                forced[:, t:t + 1]), prompt.shape[1] + t, tcfg)
            lgs.append(lg)
    return {"prefill": pre.float().numpy(),
            "decode": torch.stack(lgs, 1).float().numpy()}


def assemble(ranks: list, key: str, n_batch: int, n_vocab: int):
    """The whole tensor from the ranks' blocks: batch blocks (rows) along
    dim 0, vocab blocks along the last dim, by each rank's ``coords``
    (batch block, vocab block); ranks holding the same block must agree
    bitwise."""
    by = {}
    for r in ranks:
        c = r["coords"]
        if c in by:
            np.testing.assert_array_equal(by[c][key], r[key])
        by[c] = r
    return np.concatenate([np.concatenate(
        [by[(i, j)][key] for j in range(n_vocab)], -1)
        for i in range(n_batch)], 0)


def hybrid_smoke_model(n_layers: int, seed: int = 0, **kw):
    """(reference cfg, port cfg, numpy tree) of the recurrentgemma-9b smoke
    config at ``n_layers`` (``kw`` on both configs): the tree drawn by the
    port's ``init_lm(seed)`` (the reference's random init of the hybrid
    takes seconds), ``lambda`` the reference's own expression evaluated by
    JAX, the norm gains 1 + 0.1 N(0, 1) and the gate biases 0.5 N(0, 1)
    from ``numpy.random.default_rng(seed)``, so they carry numbers."""
    import torch

    jcfg = jsmoke(jget("recurrentgemma-9b")).with_(n_layers=n_layers, **kw)
    tcfg = tsmoke(tget("recurrentgemma-9b")).with_(n_layers=n_layers, **kw)

    def np_tree(t):
        if isinstance(t, dict):
            return {k: np_tree(v) for k, v in t.items()}
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(BF16)
        return t.numpy()

    tree = np_tree(bridge.init_lm(seed, tcfg, "cpu"))
    lam = np.asarray(jnp.log(jnp.expm1(-jnp.log(jnp.linspace(
        0.9, 0.999, jcfg.lru_dim)) / 8.0)).astype(jnp.float32))
    rng = np.random.default_rng(seed)

    def perturb(t):
        for k, v in t.items():
            if isinstance(v, dict):
                perturb(v)
            elif k in ("ln1", "ln2", "final_ln"):
                t[k] = (1 + 0.1 * rng.standard_normal(v.shape)).astype(BF16)
            elif k in ("b_a", "b_x"):
                t[k] = (0.5 * rng.standard_normal(v.shape)).astype(
                    np.float32)
            elif k == "lambda":
                t[k] = np.broadcast_to(lam, v.shape).copy()
    perturb(tree)
    return jcfg, tcfg, tree

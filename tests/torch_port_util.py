"""Shared helpers of the port's parity tests (tests/test_torch_*.py): random
Flax params from a numpy seed, and their carry-over into torch modules."""

import jax
import numpy as np
import torch

from latte_tpu_torch.convert import qkv_to_reference

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def randomize(params, seed=0, std=0.2):
    """Replace every leaf with N(0, std²) noise from a numpy seed, so the
    zero-initialised adaLN and output layers carry signal too."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    new = [(std * rng.standard_normal(np.shape(x))).astype(np.float32) for x in leaves]
    return jax.tree_util.tree_unflatten(treedef, new)


def load_linear(lin: torch.nn.Linear, p) -> None:
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(np.asarray(p["kernel"]).T.copy()))
        lin.bias.copy_(torch.from_numpy(np.asarray(p["bias"])))


def load_qkv(lin: torch.nn.Linear, p, num_heads: int) -> None:
    w, b = qkv_to_reference(p["kernel"], p["bias"], num_heads)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w))
        lin.bias.copy_(torch.from_numpy(b))


def load_block(blk, p, num_heads: int) -> None:
    load_qkv(blk.attn.qkv, p["attn"]["qkv"], num_heads)
    load_linear(blk.attn.proj, p["attn"]["proj"])
    load_linear(blk.mlp.fc1, p["mlp"]["fc1"])
    load_linear(blk.mlp.fc2, p["mlp"]["fc2"])
    load_linear(blk.adaLN_modulation[1], p["adaLN_modulation"])


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def close(got, want, rel=1e-5, elem=1e-4):
    """``got`` within ``rel`` of ``want`` in relative L2 norm, and no element
    off by more than ``elem`` of ``want``'s largest magnitude."""
    got = (got.detach().double().numpy() if isinstance(got, torch.Tensor)
           else np.asarray(got, np.float64))
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= rel, f"relative L2 error {err:.3g} > {rel:.3g}"
    np.testing.assert_allclose(got, want, rtol=0, atol=elem * np.abs(want).max())

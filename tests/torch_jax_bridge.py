"""Helpers the port's tests share: a JAX engine's state carried into the
port (``serve.train_state_from_jax``) and a port state as numpy arrays."""

import jax
import numpy as np

from recmodels_tpu.serve import _canonical_tables
from recmodels_tpu_torch.serve import train_state_from_jax
from recmodels_tpu_torch.utils.tree import leaves


def port_state_from_jax(jeng, jstate, eng, device="cpu"):
    """``eng``'s state holding ``jstate`` (a JAX ``TrainState`` of
    ``jeng``): parameters, both optimizer states and the step."""
    jstate = jax.device_get(jstate)
    emb_opt = {f"emb/{c}/{g}": {k: np.asarray(v) for k, v in st.items()}
               for c, groups in jstate.emb_opt.items() for g, st in groups.items()}
    return train_state_from_jax(
        eng, int(jstate.step), [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate.dense_params)],
        dense_opt=jstate.dense_opt, emb_tables=_canonical_tables(jeng, jstate.emb_params),
        emb_opt=emb_opt, device=device)


def port_arrays(state) -> list:
    """Every tensor of a port state as a numpy array, in a fixed order."""
    return [t.detach().cpu().numpy().copy() for t in leaves(state._asdict())]


def port_names(tree, prefix: str = "") -> list:
    """The paths of ``port_arrays``' arrays ("dense_params/mlp/0/w", ...)."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in port_names(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in port_names(v, f"{prefix}{i}/")]
    return [prefix[:-1]]


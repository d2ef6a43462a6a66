"""The port's checkpoints and the JAX package's are one format (npz schema
v2, leaves under their pytree path names): a checkpoint written by either
package loads into the other's TrainState with equal leaves, both read the
same capacity and step, and both refuse a bad file with the same message."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from curve_gaussian_tpu.engine import checkpoint as jck
from curve_gaussian_tpu.engine import optim as joptim
from curve_gaussian_tpu.engine import train as jtrain

from curve_gaussian_tpu_torch import convert
from curve_gaussian_tpu_torch.engine import checkpoint as pck

CAP, M, V = 256, 4, 3
GROUPS = {"curve_points": (4, 3), "exposure": None, "features_dc": (M, 1), "mask_raw": (M,),
          "opacity_raw": (), "width_raw": ()}


def _leaves(seed):
    """Seeded numpy leaves of a TrainState at capacity CAP."""
    rng = np.random.default_rng(seed)

    def group():
        return {k: rng.normal(size=(V, 2) if s is None else (CAP,) + s).astype(np.float32)
                for k, s in GROUPS.items()}

    return dict(params=group(), mu=group(), nu=group(), count=int(rng.integers(1, 999)),
                is_bezier=rng.uniform(size=CAP) < 0.7, alive=np.arange(CAP) < 200,
                xyz_grad_accum=rng.uniform(size=CAP * M).astype(np.float32),
                denom=rng.integers(0, 9, CAP * M).astype(np.float32),
                max_radii=rng.integers(0, 40, CAP * M).astype(np.int32),
                step=int(rng.integers(1, 999)), opacity_frozen=True)


def _jax_ts(a):
    cast = lambda d: {k: jnp.asarray(v) for k, v in d.items()}  # noqa: E731
    return jtrain.TrainState(
        params=cast(a["params"]),
        opt=joptim.AdamState(mu=cast(a["mu"]), nu=cast(a["nu"]),
                             count=jnp.asarray(a["count"], jnp.int32)),
        is_bezier=jnp.asarray(a["is_bezier"]), alive=jnp.asarray(a["alive"]),
        xyz_grad_accum=jnp.asarray(a["xyz_grad_accum"]), denom=jnp.asarray(a["denom"]),
        max_radii=jnp.asarray(a["max_radii"]), step=jnp.asarray(a["step"], jnp.int32),
        opacity_frozen=jnp.asarray(a["opacity_frozen"]),
    )


def _port_ts(a):
    return convert.train_state_from_numpy(
        a["params"], a["mu"], a["nu"], a["count"], a["is_bezier"], a["alive"],
        a["xyz_grad_accum"], a["denom"], a["max_radii"], a["step"], a["opacity_frozen"],
        device="cpu")


def _jax_named(ts):
    named, _ = jck._named_leaves(ts)
    return {k: np.asarray(v) for k, v in named.items()}


def _assert_equal(port_ts, jax_ts):
    jn = _jax_named(jax_ts)
    pn = {k: pck.leaf_array(v) for k, v in pck.named_leaves(port_ts).items()}
    assert list(pn) == list(jn)
    for k, v in jn.items():
        assert pn[k].dtype == v.dtype and np.array_equal(pn[k], v), k


def test_jax_checkpoint_loads_into_the_port(tmp_path):
    path = str(tmp_path / "jax.npz")
    src = _jax_ts(_leaves(0))
    jck.save_checkpoint(path, src)
    assert pck.checkpoint_capacity(path) == jck.checkpoint_capacity(path) == (CAP, int(src.step))
    loaded = pck.load_checkpoint(path, _port_ts(_leaves(1)))
    _assert_equal(loaded, src)
    assert loaded.params["curve_points"].dtype == torch.float32
    assert isinstance(loaded.step, int) and loaded.opacity_frozen is True


def test_port_checkpoint_loads_into_jax(tmp_path):
    path = str(tmp_path / "port.npz")
    src = _port_ts(_leaves(2))
    pck.save_checkpoint(path, src)
    assert jck.checkpoint_capacity(path) == pck.checkpoint_capacity(path) == (CAP, src.step)
    loaded = jck.load_checkpoint(path, _jax_ts(_leaves(3)))
    _assert_equal(src, loaded)
    # and back into the port, bitwise
    _assert_equal(pck.load_checkpoint(path, _port_ts(_leaves(4))), loaded)


def _bad_files(tmp_path):
    """(name, path, template capacity) of checkpoints both packages refuse."""
    good = str(tmp_path / "good.npz")
    jck.save_checkpoint(good, _jax_ts(_leaves(5)))
    data = dict(np.load(good))
    out = []
    for name, edit in (
        ("no schema", lambda d: d.pop("__schema_version")),
        ("schema v1", lambda d: d.__setitem__("__schema_version", np.asarray(1))),
        ("missing leaf", lambda d: d.pop("opt/mu/mask_raw")),
    ):
        d = dict(data)
        edit(d)
        path = str(tmp_path / f"{name.replace(' ', '_')}.npz")
        np.savez(path, **d)
        out.append((name, path, CAP))
    out.append(("capacity", good, 2 * CAP))
    return out


def _template_leaves(cap):
    a = _leaves(6)
    if cap != CAP:
        a = {k: v for k, v in a.items()}
        reps = cap // CAP

        def grow(x):
            return np.concatenate([x] * reps) if isinstance(x, np.ndarray) else x

        for g in ("params", "mu", "nu"):
            a[g] = {k: v if k == "exposure" else grow(v) for k, v in a[g].items()}
        for k in ("is_bezier", "alive", "xyz_grad_accum", "denom", "max_radii"):
            a[k] = grow(a[k])
    return a


def test_bad_checkpoints_raise_the_same_errors(tmp_path):
    for name, path, cap in _bad_files(tmp_path):
        a = _template_leaves(cap)
        with pytest.raises(ValueError) as je:
            jck.load_checkpoint(path, _jax_ts(a))
        with pytest.raises(ValueError) as pe:
            pck.load_checkpoint(path, _port_ts(a))
        assert str(pe.value) == str(je.value), name
        if name.startswith(("no schema", "schema")):
            with pytest.raises(ValueError, match="schema|checkpoint"):
                pck.checkpoint_capacity(path)

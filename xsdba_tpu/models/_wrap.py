"""Shared glue between labeled DataArrays and the jitted cores."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..utils.container import DataArray
from ..utils.grouper import GroupIndexes

__all__ = ["Brackets", "batch_of", "device_brackets", "fold_add_dims", "grouped_var", "scen_like", "to_compute"]


class Brackets:
    """Bracket-partition bundle for the jitted cores (registered pytree).

    Children are the device index arrays (the legacy 7-tuple layout — the
    object unpacks like that tuple); aux data carries the static
    regular-layout period: when ``regular0 == P``, partition rows ``1..P`` of
    the padded-group axis are exactly the transpose of the ``[years, P]``
    reshape of the time axis and the pad rows are empty, so the partition
    gather AND the scatter back lower to reshape+swapaxes instead of element
    gathers.
    """

    def __init__(self, part0, g0, slot0, part1, g1, slot1, w, regular0=None):
        self.part0, self.g0, self.slot0 = part0, g0, slot0
        self.part1, self.g1, self.slot1, self.w = part1, g1, slot1, w
        self.regular0 = regular0

    def __iter__(self):
        return iter((self.part0, self.g0, self.slot0, self.part1, self.g1, self.slot1, self.w))

    def tree_flatten(self):
        return (
            (self.part0, self.g0, self.slot0, self.part1, self.g1, self.slot1, self.w),
            (self.regular0,),
        )

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, regular0=aux[0])


import jax  # noqa: E402

jax.tree_util.register_pytree_node_class(Brackets)


def device_brackets(gi: GroupIndexes, method: str = "linear"):
    """Device-ready bracket partitions for the jitted cores.

    Collapsed brackets (nearest method, integer fractional indexes like
    dayofyear) drop the second partition entirely (None is static pytree
    structure, so the cores compile the single-partition path).
    """
    import jax.numpy as jnp

    b = gi.bracket_partitions(method)
    part0 = jnp.asarray(b["part0"])
    g0 = jnp.asarray(b["g0"])
    slot0 = jnp.asarray(b["slot0"])
    # collapsed brackets, or integer fractional indexes (dayofyear): the g1
    # side always has zero weight, so skip its partition entirely
    if bool((b["g0"] == b["g1"]).all()) or bool((b["w"] == 0).all()):
        return Brackets(part0, g0, slot0, None, None, None, None, regular0=b.get("regular0"))
    return Brackets(
        part0,
        g0,
        slot0,
        jnp.asarray(b["part1"]),
        jnp.asarray(b["g1"]),
        jnp.asarray(b["slot1"]),
        jnp.asarray(b["w"]),
        regular0=b.get("regular0"),
    )


_DEV_CACHE: dict = {}
_DEV_CACHE_MAX = 32


def _fingerprint(a: np.ndarray) -> int:
    """Cheap content fingerprint (~1k sampled elements): realistic in-place
    mutations (whole-array or blockwise updates) change it and so invalidate
    the buffer-identity cache; a surgical single-element edit between the
    sample points can still escape — the documented contract asks callers
    not to mutate inputs in place."""
    import zlib

    flat = np.ravel(a)
    if flat.size == 0:
        return 0
    step = max(1, flat.size // 1024)
    sample = np.concatenate([flat[::step][:1025], flat[-8:]])
    return zlib.crc32(sample.tobytes())


def to_device_cached(a):
    """Device copy of a host array, cached by buffer identity + fingerprint.

    Repeated public-API calls on the same numpy-backed DataArrays (train then
    adjust, parameter sweeps) would otherwise re-upload identical inputs on
    every call.  Keys carry the owning
    buffer id + (ptr, shape, strides, dtype) so numpy views hit the cache
    too, plus a sampled content fingerprint so in-place mutation between
    calls is detected (see :func:`_fingerprint` for the escape hatch);
    entries die with the owning buffer, with an LRU cap as backstop.
    """
    import weakref

    import jax.numpy as jnp

    if not isinstance(a, np.ndarray):
        return jnp.asarray(a)
    owner = a.base if a.base is not None else a
    try:
        ptr = a.__array_interface__["data"][0]
    except Exception:
        return jnp.asarray(a)
    key = (id(owner), ptr, a.shape, a.strides, a.dtype.str, _fingerprint(a))
    hit = _DEV_CACHE.get(key)
    if hit is not None:
        return hit
    dev = jnp.asarray(a)
    while len(_DEV_CACHE) >= _DEV_CACHE_MAX:
        _DEV_CACHE.pop(next(iter(_DEV_CACHE)))
    _DEV_CACHE[key] = dev
    try:
        weakref.finalize(owner, _DEV_CACHE.pop, key, None)
    except TypeError:
        # owner not weakref-able (bytes/memoryview/mmap base): the entry
        # could never be invalidated and its (id, ptr, ...) key is
        # recyclable after GC — don't cache at all
        _DEV_CACHE.pop(key, None)
    return dev


def to_compute(da: DataArray):
    """DataArray -> (device array [..., T], batch dims, batch coords)."""
    da = da.move_dim_last("time")
    batch_dims = da.dims[:-1]
    batch_coords = {d: da.coords[d] for d in batch_dims if d in da.coords}
    return to_device_cached(da.data), batch_dims, batch_coords


def fold_add_dims(group, *das: DataArray):
    """Fold ``group.add_dims`` batch dims into the time axis for pooled
    training (reference ``base.py:413``: the grouped reduction runs over
    ``[dim] + add_dims + window``).

    Arrays missing one of the add_dims are first broadcast over it, matching
    the implicit xarray ``Dataset`` broadcast in the reference's
    ``Grouper.group``.  Returns ``(arrays [..., A*T], batch_dims,
    batch_coords, n_add)`` — pair with ``GroupIndexes.expand(n_add)``.
    """
    adims = list(group.add_dims)
    sizes: dict[str, int] = {}
    for da in das:
        for d, s in zip(da.dims, da.shape):
            if d in adims:
                sizes[d] = s
    if any(d not in sizes for d in adims):
        raise ValueError("`add_dims` argument needs to be a dimension in one of the input datasets.")
    n_add = int(np.prod([sizes[d] for d in adims], dtype=np.int64))

    outs = []
    bdims: tuple = ()
    bcoords: dict = {}
    for i, da in enumerate(das):
        dac = da.move_dim_last("time")
        arr = jnp.asarray(dac.data)
        dims = list(dac.dims)
        for d in adims:
            if d not in dims:
                arr = jnp.broadcast_to(arr[..., None, :], arr.shape[:-1] + (sizes[d], arr.shape[-1]))
                dims.insert(len(dims) - 1, d)
        perm = (
            [j for j, d in enumerate(dims) if d not in adims and d != "time"]
            + [dims.index(d) for d in adims]
            + [dims.index("time")]
        )
        arr = jnp.transpose(arr, perm)
        batch = arr.shape[: arr.ndim - 1 - len(adims)]
        outs.append(arr.reshape(batch + (n_add * arr.shape[-1],)))
        if i == 0:
            bdims = tuple(dims[j] for j in perm if dims[j] not in adims and dims[j] != "time")
            bcoords = {d: dac.coords[d] for d in bdims if d in dac.coords}
    return outs, bdims, bcoords, n_add


def batch_of(da: DataArray):
    return tuple(s for d, s in zip(da.dims, da.shape) if d != "time")


def grouped_var(
    values,
    batch_dims,
    batch_coords,
    gi: GroupIndexes,
    extra_dim: tuple[str, np.ndarray] | None = None,
    attrs=None,
    name=None,
) -> DataArray:
    """Wrap a [..., G(, nq)] core output into a labeled DataArray."""
    prop = "group" if gi.prop == "group" else gi.prop
    dims = tuple(batch_dims) + (prop,)
    coords = dict(batch_coords)
    coords[prop] = gi.coord
    if extra_dim is not None:
        dims = dims + (extra_dim[0],)
        coords[extra_dim[0]] = extra_dim[1]
    return DataArray(values, dims, coords, attrs or {}, name)


def scen_like(sim: DataArray, values, name: str = "scen") -> DataArray:
    """Wrap adjusted values (time-last layout) back into sim's dim order."""
    simc = sim.move_dim_last("time")
    out = DataArray(values, simc.dims, dict(simc.coords), dict(sim.attrs), name)
    if simc.dims != sim.dims:
        out = out.transpose(*sim.dims)
    return out

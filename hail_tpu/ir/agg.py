"""Vectorized aggregators: init/seq/comb/result split.

Vectorized analogue of the reference's staged aggregators
(`is/hail/expr/ir/agg/`, extracted by `agg/Extract.scala:26-146`): each
aggregator computes a vectorized partial state per partition (a reduction
along the given axes of the columnar batch), partials combine as a monoid
across partitions (the reference's tree-reduce, `LowerTableIR.scala:835`),
and `result` materializes the final column. Numeric states are numpy arrays,
so an (R, C) entries block reduced along axis=1 yields an (R,) state with no
python loops.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import types as ht
from ..utils.structs import Struct, frozendict
from . import columns as C
from .columns import Column, DenseArrayColumn, ObjectColumn, PrimitiveColumn, StructColumn
from .nodes import IR, AggOp, EvalEnv, find_nodes, substitute_aggs


def _flatten_vals(col):
    from .columns import _flatten
    return _flatten(col.to_pylist(), len(col.shape))


class Aggregator:
    name: str = '?'

    def result_type(self, arg_types: Sequence[ht.HailType], init_args: Sequence[Any]) -> ht.HailType:
        raise NotImplementedError

    def seq(self, arg_cols: Sequence[Column], include: Optional[np.ndarray],
            axis: Tuple[int, ...], init_args: Sequence[Any]):
        """Compute a partial state by reducing over `axis`. `include` is a bool
        mask over the full shape (True = row passes agg filters)."""
        raise NotImplementedError

    def comb(self, a, b, init_args):
        raise NotImplementedError

    def result(self, state, init_args) -> Column:
        raise NotImplementedError


def _include_and_defined(col: Column, include: Optional[np.ndarray]) -> np.ndarray:
    m = ~col.missing_mask()
    if include is not None:
        m = m & include
    return np.broadcast_to(m, col.shape) if m.shape != col.shape else m


def _full_shape(cols, include):
    shapes = [c.shape for c in cols]
    if include is not None:
        shapes.append(include.shape)
    return np.broadcast_shapes(*shapes) if shapes else (1,)


class CountAgg(Aggregator):
    name = 'count'

    def result_type(self, arg_types, init_args):
        return ht.tint64

    def seq(self, arg_cols, include, axis, init_args, shape=None):
        assert shape is not None
        if include is None:
            counts = np.full([s for i, s in enumerate(shape) if i not in axis],
                             int(np.prod([shape[i] for i in axis])), dtype=np.int64)
        else:
            counts = np.sum(np.broadcast_to(include, shape), axis=axis, dtype=np.int64)
        return counts

    def comb(self, a, b, init_args):
        return a + b

    def result(self, state, init_args):
        return PrimitiveColumn(ht.tint64, np.asarray(state), None)


class CountWhereAgg(Aggregator):
    name = 'count_where'

    def result_type(self, arg_types, init_args):
        return ht.tint64

    def seq(self, arg_cols, include, axis, init_args):
        (cond,) = arg_cols
        ok = _include_and_defined(cond, include)
        vals = np.asarray(cond.values, dtype=bool) if isinstance(cond, PrimitiveColumn) \
            else np.asarray([v is True for v in C.to_object(cond).values.ravel()]).reshape(cond.shape)
        return np.sum(ok & vals, axis=axis, dtype=np.int64)

    def comb(self, a, b, init_args):
        return a + b

    def result(self, state, init_args):
        return PrimitiveColumn(ht.tint64, np.asarray(state), None)


def _numeric_values(col: Column) -> np.ndarray:
    if isinstance(col, PrimitiveColumn):
        return col.values
    obj = C.to_object(col)
    return np.asarray([0 if v is None else v for v in obj.values.ravel()], dtype=np.float64).reshape(col.shape)


class SumAgg(Aggregator):
    name = 'sum'

    def result_type(self, arg_types, init_args):
        t = arg_types[0]
        if isinstance(t, ht.tarray):
            return ht.tarray(ht.tint64 if t.element_type in (ht.tint32, ht.tint64) else ht.tfloat64)
        return ht.tint64 if t in (ht.tint32, ht.tint64) else ht.tfloat64

    def seq(self, arg_cols, include, axis, init_args):
        (x,) = arg_cols
        if isinstance(x, DenseArrayColumn):
            ok = _include_and_defined(x, include)
            ew = np.arange(x.width)[None] < x.lengths.reshape(-1, 1)
            ew = ew.reshape(x.shape + (x.width,))
            if x.elem_missing is not None:
                ew = ew & ~x.elem_missing
            w = (ok[..., None] & ew)
            dt = np.int64 if x.typ.element_type in (ht.tint32, ht.tint64) else np.float64
            vals = np.where(w, x.values, 0).astype(dt)
            return np.sum(vals, axis=axis)
        ok = _include_and_defined(x, include)
        dt = np.int64 if x.typ in (ht.tint32, ht.tint64, ht.tbool) else np.float64
        vals = np.where(ok, np.broadcast_to(x.values, ok.shape), 0).astype(dt)
        return np.sum(vals, axis=axis)

    def comb(self, a, b, init_args):
        return a + b

    def result(self, state, init_args):
        state = np.asarray(state)
        if state.dtype == np.int64:
            return PrimitiveColumn(ht.tint64, state, None)
        return PrimitiveColumn(ht.tfloat64, state, None)


class ArraySumAgg(SumAgg):
    name = 'array_sum'

    def result(self, state, init_args):
        state = np.asarray(state)
        et = ht.tint64 if state.dtype == np.int64 else ht.tfloat64
        lengths = np.full(state.shape[:-1], state.shape[-1], dtype=np.int32)
        return DenseArrayColumn(ht.tarray(et), state, lengths)


class NDArraySumAgg(Aggregator):
    """Elementwise sum of same-shape ndarrays (reference aggregators.py:961
    ndarray_sum / NDArraySum)."""

    name = 'ndarray_sum'

    def result_type(self, arg_types, init_args):
        return arg_types[0]

    def seq(self, arg_cols, include, axis, init_args):
        (x,) = arg_cols
        obj = C.to_object(x)
        ok = _include_and_defined(x, include)
        vals = np.broadcast_to(obj.values, ok.shape)
        axis = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
        kept_dims = [d for d in range(ok.ndim) if d not in axis]
        out_shape = tuple(ok.shape[d] for d in kept_dims)
        out = np.empty(out_shape if out_shape else (), dtype=object)
        for out_idx in np.ndindex(out_shape if out_shape else ()):
            acc = None
            red_shape = tuple(ok.shape[d] for d in axis)
            for red_idx in np.ndindex(red_shape):
                full = [None] * ok.ndim
                for d, i in zip(kept_dims, out_idx):
                    full[d] = i
                for d, i in zip(axis, red_idx):
                    full[d] = i
                full = tuple(full)
                if not ok[full]:
                    continue
                v = vals[full]
                if v is None:
                    continue
                a = np.asarray(v, dtype=np.float64)
                if acc is not None and acc.shape != a.shape:
                    from ..utils.misc import FatalError
                    raise FatalError(
                        f"Can't sum ndarrays of different shapes: "
                        f'{acc.shape} vs {a.shape}')
                acc = a.copy() if acc is None else acc + a
            if out_shape:
                out[out_idx] = acc
            else:
                out = acc
        return out

    def comb(self, a, b, init_args):
        if a is None:
            return b
        if b is None:
            return a
        def add(x, y):
            if x is None:
                return y
            if y is None:
                return x
            if x.shape != y.shape:
                from ..utils.misc import FatalError
                raise FatalError(
                    f"Can't sum ndarrays of different shapes: "
                    f'{x.shape} vs {y.shape}')
            return x + y
        if isinstance(a, np.ndarray) and a.dtype == object:
            out = np.empty(a.shape, dtype=object)
            for i in np.ndindex(a.shape):
                out[i] = add(a[i], b[i])
            return out
        return add(a, b)

    def result(self, state, init_args):
        t = getattr(self, '_result_t', None) or ht.tndarray(ht.tfloat64, 2)
        if isinstance(state, np.ndarray) and state.dtype == object:
            return ObjectColumn(t, state)
        out = np.empty(1, dtype=object)
        out[0] = state
        return ObjectColumn(t, out[:1]).reshape(())


class DensifyAgg(Aggregator):
    """scan._densify(len, arr): per-position forward fill — output slot j
    holds the last non-missing element seen at index j in earlier rows
    (reference Densify agg, used by vds to_dense)."""

    name = '_densify'

    def result_type(self, arg_types, init_args):
        return arg_types[0]

    def _run(self, x, lcol, carry):
        obj = C.to_object(x)
        flat = obj.values.ravel()
        width = int(np.asarray(C.to_object(lcol).values).ravel()[0])
        state = list(carry) if carry is not None else [None] * width
        outs = np.empty(flat.size, dtype=object)
        for i in range(flat.size):
            outs[i] = list(state)
            v = flat[i]
            if v is not None:
                for j, e in enumerate(v[:width]):
                    if e is not None:
                        state[j] = e
        return outs, state

    def seq(self, arg_cols, include, axis, init_args):
        x, lcol = arg_cols
        _, state = self._run(x, lcol, None)
        return state

    def comb(self, a, b, init_args):
        out = list(a)
        for j, e in enumerate(b):
            if e is not None:
                if j < len(out):
                    out[j] = e
        return out

    def result(self, state, init_args):
        rt = getattr(self, '_result_t', None)
        return C.from_pylist(rt, [list(state)])


class PrevNonnullAgg(Aggregator):
    """Last non-missing value in order (reference PrevNonnull agg, used by
    densify scans)."""

    name = 'prev_nonnull'

    def result_type(self, arg_types, init_args):
        return arg_types[0]

    def seq(self, arg_cols, include, axis, init_args):
        (x,) = arg_cols
        ok = _include_and_defined(x, include)
        obj = C.to_object(x)
        vals = np.broadcast_to(obj.values, ok.shape)
        axis = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
        kept_dims = [d for d in range(ok.ndim) if d not in axis]
        out_shape = tuple(ok.shape[d] for d in kept_dims)
        out = np.empty(out_shape if out_shape else (), dtype=object)
        for out_idx in np.ndindex(out_shape if out_shape else ()):
            last = None
            for red_idx in np.ndindex(tuple(ok.shape[d] for d in axis)):
                full = [None] * ok.ndim
                for d, i in zip(kept_dims, out_idx):
                    full[d] = i
                for d, i in zip(axis, red_idx):
                    full[d] = i
                full = tuple(full)
                if ok[full] and vals[full] is not None:
                    last = vals[full]
            if out_shape:
                out[out_idx] = last
            else:
                out = last
        return out

    def comb(self, a, b, init_args):
        if isinstance(b, np.ndarray) and b.dtype == object:
            out = np.empty(b.shape, dtype=object)
            for i in np.ndindex(b.shape):
                out[i] = b[i] if b[i] is not None else (a[i] if isinstance(a, np.ndarray) else a)
            return out
        return b if b is not None else a

    def result(self, state, init_args):
        t = getattr(self, '_result_t', None) or ht.tstr
        if isinstance(state, np.ndarray) and state.dtype == object:
            return ObjectColumn(t, state)
        out = np.empty(1, dtype=object)
        out[0] = state
        return ObjectColumn(t, out[:1]).reshape(())


class ReservoirSampleAgg(Aggregator):
    """Uniform random sample of n records (reference ReservoirSample agg)."""

    name = 'reservoir_sample'

    def result_type(self, arg_types, init_args):
        return ht.tarray(arg_types[0])

    def seq(self, arg_cols, include, axis, init_args):
        (x,) = arg_cols
        ok = _include_and_defined(x, include)
        obj = C.to_object(x)
        vals = np.broadcast_to(obj.values, ok.shape)
        flat_ok = ok.ravel()
        flat_v = vals.ravel()
        return [flat_v[i] for i in range(flat_ok.size) if flat_ok[i]]

    def comb(self, a, b, init_args):
        return list(a) + list(b)

    def result(self, state, init_args):
        (n,) = init_args
        t = self._result_t if hasattr(self, '_result_t') else ht.tarray(ht.tfloat64)
        vals = list(state)
        if len(vals) > n:
            rng = np.random.default_rng(len(vals))
            idx = sorted(rng.choice(len(vals), int(n), replace=False))
            vals = [vals[i] for i in idx]
        out = np.empty(1, dtype=object)
        out[0] = vals
        return ObjectColumn(t, out[:1]).reshape(())


class ProductAgg(Aggregator):
    name = 'product'

    def result_type(self, arg_types, init_args):
        t = arg_types[0]
        return ht.tint64 if t in (ht.tint32, ht.tint64) else ht.tfloat64

    def seq(self, arg_cols, include, axis, init_args):
        (x,) = arg_cols
        ok = _include_and_defined(x, include)
        dt = np.int64 if x.typ in (ht.tint32, ht.tint64) else np.float64
        vals = np.where(ok, np.broadcast_to(x.values, ok.shape), 1).astype(dt)
        return np.prod(vals, axis=axis)

    def comb(self, a, b, init_args):
        return a * b

    def result(self, state, init_args):
        state = np.asarray(state)
        t = ht.tint64 if state.dtype == np.int64 else ht.tfloat64
        return PrimitiveColumn(t, state, None)


class MinMaxAgg(Aggregator):
    def __init__(self, is_min: bool):
        self.is_min = is_min
        self.name = 'min' if is_min else 'max'

    def result_type(self, arg_types, init_args):
        return arg_types[0]

    def seq(self, arg_cols, include, axis, init_args):
        (x,) = arg_cols
        ok = _include_and_defined(x, include)
        vals = np.broadcast_to(np.asarray(_numeric_values(x), dtype=np.float64), ok.shape)
        # NaN records are skipped (reference agg.min/max semantics)
        ok = ok & ~np.isnan(vals)
        fill = np.inf if self.is_min else -np.inf
        vals = np.where(ok, vals, fill)
        f = np.min if self.is_min else np.max
        with np.errstate(all='ignore'):
            red = f(vals, axis=axis) if vals.size else np.full([s for i, s in enumerate(ok.shape) if i not in axis], fill)
        n = np.sum(ok, axis=axis)
        return (red, n > 0, x.typ)

    def comb(self, a, b, init_args):
        f = np.minimum if self.is_min else np.maximum
        return (f(a[0], b[0]), a[1] | b[1], a[2])

    def result(self, state, init_args):
        vals, defined, typ = state
        vals = np.asarray(vals)
        out = vals.astype(typ.numpy_dtype) if typ.numpy_dtype is not None else vals
        miss = ~np.asarray(defined)
        return PrimitiveColumn(typ, np.where(miss, 0, out).astype(typ.numpy_dtype), miss if miss.any() else None)


class MeanAgg(Aggregator):
    name = 'mean'

    def result_type(self, arg_types, init_args):
        return ht.tfloat64

    def seq(self, arg_cols, include, axis, init_args):
        (x,) = arg_cols
        ok = _include_and_defined(x, include)
        vals = np.where(ok, np.broadcast_to(x.values, ok.shape), 0).astype(np.float64)
        return (np.sum(vals, axis=axis), np.sum(ok, axis=axis, dtype=np.int64))

    def comb(self, a, b, init_args):
        return (a[0] + b[0], a[1] + b[1])

    def result(self, state, init_args):
        s, n = state
        with np.errstate(all='ignore'):
            mean = np.asarray(s, dtype=np.float64) / n
        miss = np.asarray(n) == 0
        return PrimitiveColumn(ht.tfloat64, np.where(miss, 0.0, mean), miss if miss.any() else None)


class StatsAgg(Aggregator):
    name = 'stats'
    _result_t = ht.tstruct(mean=ht.tfloat64, stdev=ht.tfloat64, min=ht.tfloat64,
                           max=ht.tfloat64, n=ht.tint64, sum=ht.tfloat64)

    def result_type(self, arg_types, init_args):
        return self._result_t

    def seq(self, arg_cols, include, axis, init_args):
        (x,) = arg_cols
        ok = _include_and_defined(x, include)
        vals = np.where(ok, np.broadcast_to(x.values, ok.shape), 0).astype(np.float64)
        s = np.sum(vals, axis=axis)
        s2 = np.sum(vals * vals, axis=axis)
        n = np.sum(ok, axis=axis, dtype=np.int64)
        mn = np.min(np.where(ok, np.broadcast_to(x.values, ok.shape), np.inf), axis=axis) if vals.size else np.full_like(s, np.inf)
        mx = np.max(np.where(ok, np.broadcast_to(x.values, ok.shape), -np.inf), axis=axis) if vals.size else np.full_like(s, -np.inf)
        return (s, s2, n, mn, mx)

    def comb(self, a, b, init_args):
        return (a[0] + b[0], a[1] + b[1], a[2] + b[2], np.minimum(a[3], b[3]), np.maximum(a[4], b[4]))

    def result(self, state, init_args):
        s, s2, n, mn, mx = (np.asarray(v) for v in state)
        miss = n == 0
        with np.errstate(all='ignore'):
            mean = s / n
            var = s2 / n - mean * mean
            stdev = np.sqrt(np.maximum(var, 0.0))
        shape = s.shape
        anymiss = miss if miss.any() else None
        return StructColumn(self._result_t, {
            'mean': PrimitiveColumn(ht.tfloat64, np.where(miss, 0.0, mean), anymiss),
            'stdev': PrimitiveColumn(ht.tfloat64, np.where(miss, 0.0, stdev), anymiss),
            'min': PrimitiveColumn(ht.tfloat64, np.where(miss, 0.0, mn), anymiss),
            'max': PrimitiveColumn(ht.tfloat64, np.where(miss, 0.0, mx), anymiss),
            'n': PrimitiveColumn(ht.tint64, n, None),
            'sum': PrimitiveColumn(ht.tfloat64, s, None),
        }, None, shape)


class AnyAllAgg(Aggregator):
    def __init__(self, is_any: bool):
        self.is_any = is_any
        self.name = 'any' if is_any else 'all'

    def result_type(self, arg_types, init_args):
        return ht.tbool

    def seq(self, arg_cols, include, axis, init_args):
        (x,) = arg_cols
        ok = _include_and_defined(x, include)
        vals = np.broadcast_to(np.asarray(x.values, dtype=bool), ok.shape)
        if self.is_any:
            return np.any(ok & vals, axis=axis)
        return np.all(~ok | vals, axis=axis)

    def comb(self, a, b, init_args):
        return (a | b) if self.is_any else (a & b)

    def result(self, state, init_args):
        return PrimitiveColumn(ht.tbool, np.asarray(state), None)


class FractionAgg(Aggregator):
    name = 'fraction'

    def result_type(self, arg_types, init_args):
        return ht.tfloat64

    def seq(self, arg_cols, include, axis, init_args):
        (x,) = arg_cols
        ok = _include_and_defined(x, include)
        vals = np.broadcast_to(np.asarray(x.values, dtype=bool), ok.shape)
        return (np.sum(ok & vals, axis=axis, dtype=np.int64), np.sum(ok, axis=axis, dtype=np.int64))

    def comb(self, a, b, init_args):
        return (a[0] + b[0], a[1] + b[1])

    def result(self, state, init_args):
        t, n = (np.asarray(v) for v in state)
        miss = n == 0
        with np.errstate(all='ignore'):
            frac = t / n
        return PrimitiveColumn(ht.tfloat64, np.where(miss, 0.0, frac), miss if miss.any() else None)


class _PerPosState(list):
    """Marker type: a list of per-output-position collect states (partial-axis
    reduce). Distinguishes [state, state, ...] from a single full-reduction
    state whose ELEMENTS happen to be lists (e.g. collecting array values)."""


class CollectAgg(Aggregator):
    """collect / collect_as_set / counter — object-state aggregators.

    States are per-output-position python lists; vectorized for the axis=all
    (scalar) case, loop-based for partial axes.
    """

    def __init__(self, kind: str):
        self.kind = kind
        self.name = kind

    def result_type(self, arg_types, init_args):
        t = arg_types[0]
        if self.kind == 'collect':
            return ht.tarray(t)
        if self.kind == 'collect_as_set':
            return ht.tset(t)
        return ht.tdict(t, ht.tint64)

    def seq(self, arg_cols, include, axis, init_args):
        (x,) = arg_cols
        if self.kind in ('counter', 'collect'):
            # counter keys and collect elements include missing (reference
            # CollectAggregator stores optional elements; test_agg_explode)
            ok = np.ones(x.shape, dtype=bool) if include is None else \
                np.broadcast_to(include, x.shape)
        else:
            ok = _include_and_defined(x, include)
        pyl = C.obj_array(_flatten_vals(x), x.shape)
        pyl = np.broadcast_to(pyl, ok.shape)
        ndim = len(ok.shape)
        if len(axis) == ndim:
            flat_ok = ok.ravel()
            flat_v = pyl.ravel()
            return [v for v, k in zip(flat_v, flat_ok) if k]
        # partial reduce: iterate over the kept axis
        keep_ax = [i for i in range(ndim) if i not in axis][0]
        moved_ok = np.moveaxis(ok, keep_ax, 0)
        moved_v = np.moveaxis(pyl, keep_ax, 0)
        out = _PerPosState()
        for i in range(moved_ok.shape[0]):
            o = moved_ok[i].ravel()
            v = moved_v[i].ravel()
            out.append([x_ for x_, k in zip(v, o) if k])
        return out

    def comb(self, a, b, init_args):
        if isinstance(a, _PerPosState):
            return _PerPosState(x + y for x, y in zip(a, b))
        return a + b

    def result(self, state, init_args):
        def fin(lst):
            if self.kind == 'collect':
                return list(lst)
            from ..utils.structs import freeze
            if self.kind == 'collect_as_set':
                return frozenset(freeze(v) for v in lst)
            d: Dict[Any, int] = {}
            for v in lst:
                k = freeze(v)
                d[k] = d.get(k, 0) + 1
            # key-sorted like the reference's counter result (dict built
            # from the engine's ordered map)
            from functools import cmp_to_key
            from ..expr.functions import _cmp_values
            return frozendict(sorted(d.items(),
                                     key=cmp_to_key(
                                         lambda x, y: _cmp_values(x[0], y[0]))))
        rt = getattr(self, '_result_t', None) or self.result_type([ht.tfloat64], init_args)
        if isinstance(state, _PerPosState):
            return C.from_pylist(rt, [fin(s) for s in state])
        return C.from_pylist(rt, [fin(state)])


class TakeAgg(Aggregator):
    name = 'take'

    def result_type(self, arg_types, init_args):
        return ht.tarray(arg_types[0])

    def seq(self, arg_cols, include, axis, init_args):
        (x,) = arg_cols
        (n,) = init_args
        ok = _include_and_defined(x, include)
        pyl = np.broadcast_to(C.obj_array(_flatten_vals(x), x.shape), ok.shape)
        flat_ok = ok.ravel()
        flat_v = pyl.ravel()
        out = []
        for v, k in zip(flat_v, flat_ok):
            if k:
                out.append(v)
                if len(out) >= n:
                    break
        return out

    def comb(self, a, b, init_args):
        (n,) = init_args
        return (a + b)[:n]

    def result(self, state, init_args):
        return C.from_pylist(self._result_t, [list(state)])


class TakeByAgg(Aggregator):
    name = 'takeby'

    def result_type(self, arg_types, init_args):
        return ht.tarray(arg_types[0])

    def seq(self, arg_cols, include, axis, init_args):
        x, key = arg_cols
        (n,) = init_args
        ok = _include_and_defined(key, include)
        xv = np.broadcast_to(C.obj_array(_flatten_vals(x), x.shape), ok.shape).ravel()
        kv = np.broadcast_to(C.obj_array(_flatten_vals(key), key.shape), ok.shape).ravel()
        pairs = [(k, v) for v, k, o in zip(xv, kv, ok.ravel()) if o]
        pairs.sort(key=lambda p: p[0])
        return pairs[:n]

    def comb(self, a, b, init_args):
        (n,) = init_args
        merged = sorted(a + b, key=lambda p: p[0])
        return merged[:n]

    def result(self, state, init_args):
        return C.from_pylist(self._result_t, [[v for _, v in state]])


class CallStatsAgg(Aggregator):
    """call_stats(GT, alleles): AC/AF/AN/homozygote_count per allele.

    Reference: `is/hail/expr/ir/agg/CallStatsAggregator` — reimplemented as a
    one-hot bincount over packed call columns (vectorizes to a segment-sum;
    on the jit tier this is an int8 matmul).
    """

    name = 'call_stats'

    @staticmethod
    def _make_result_t():
        return ht.tstruct(
            AC=ht.tarray(ht.tint32), AF=ht.tarray(ht.tfloat64),
            AN=ht.tint32, homozygote_count=ht.tarray(ht.tint32))

    def result_type(self, arg_types, init_args):
        return self._make_result_t()

    def seq(self, arg_cols, include, axis, init_args):
        from ..genetics.call import calls_allele_j, calls_allele_k, PLOIDY_MASK
        gt = arg_cols[0]
        n_alleles_col = arg_cols[1] if len(arg_cols) > 1 else None
        ok = _include_and_defined(gt, include)
        packed = np.broadcast_to(gt.values, ok.shape).astype(np.int64)
        ploidy = packed & PLOIDY_MASK
        j = calls_allele_j(packed)
        k = calls_allele_k(packed)
        if n_alleles_col is not None:
            max_alleles = int(np.max(n_alleles_col.values)) if n_alleles_col.values.size else 2
        else:
            max_alleles = int(max(np.max(j[ok], initial=0), np.max(k[ok], initial=0)) + 1) if ok.any() else 2
        max_alleles = max(max_alleles, 2)
        ndim = len(ok.shape)
        red_all = len(axis) == ndim
        # one-hot counts via bincount over (kept_pos * n_alleles + allele)
        if red_all:
            ac = np.bincount(j[ok & (ploidy >= 1)], minlength=max_alleles).astype(np.int64)
            ac = ac + np.bincount(k[ok & (ploidy == 2)], minlength=max_alleles)[:max_alleles]
            hom = np.bincount(j[ok & (ploidy == 2) & (j == k)], minlength=max_alleles).astype(np.int64)
            an = int(np.sum(np.where(ok, ploidy, 0)))
            return (ac[:max_alleles], hom[:max_alleles], np.asarray(an, dtype=np.int64))
        keep_ax = [i for i in range(ndim) if i not in axis][0]
        n_keep = ok.shape[keep_ax]
        pos = np.moveaxis(
            np.broadcast_to(
                np.arange(n_keep).reshape([-1 if i == 0 else 1 for i in range(ndim)]),
                np.moveaxis(ok, keep_ax, 0).shape),
            0, keep_ax)
        def bc(allele_arr, mask):
            idx = (pos * max_alleles + allele_arr)[mask]
            return np.bincount(idx, minlength=n_keep * max_alleles).reshape(n_keep, max_alleles).astype(np.int64)
        ac = bc(j, ok & (ploidy >= 1)) + bc(k, ok & (ploidy == 2))
        hom = bc(j, ok & (ploidy == 2) & (j == k))
        an = np.sum(np.where(ok, ploidy, 0), axis=axis, dtype=np.int64)
        return (ac, hom, an)

    def comb(self, a, b, init_args):
        ac1, hom1, an1 = a
        ac2, hom2, an2 = b
        w = max(ac1.shape[-1], ac2.shape[-1])
        def pad(x):
            if x.shape[-1] < w:
                padw = [(0, 0)] * (x.ndim - 1) + [(0, w - x.shape[-1])]
                return np.pad(x, padw)
            return x
        return (pad(ac1) + pad(ac2), pad(hom1) + pad(hom2), an1 + an2)

    def result(self, state, init_args):
        ac, hom, an = state
        ac = np.asarray(ac)
        hom = np.asarray(hom)
        an = np.asarray(an)
        scalar = ac.ndim == 1
        if scalar:
            ac = ac[None]
            hom = hom[None]
            an = np.asarray([an])
        n, w = ac.shape
        with np.errstate(all='ignore'):
            af = ac / an[..., None]
        lengths = np.full(n, w, dtype=np.int32)
        t = CallStatsAgg._make_result_t()
        shape = (n,)
        out = StructColumn(t, {
            'AC': DenseArrayColumn(ht.tarray(ht.tint32), ac.astype(np.int32), lengths),
            'AF': DenseArrayColumn(ht.tarray(ht.tfloat64), np.where(an[..., None] == 0, 0.0, af), lengths,
                                   np.broadcast_to((an == 0)[..., None], ac.shape).copy() if (an == 0).any() else None),
            'AN': PrimitiveColumn(ht.tint32, an.astype(np.int32)),
            'homozygote_count': DenseArrayColumn(ht.tarray(ht.tint32), hom.astype(np.int32), lengths),
        }, None, shape)
        return out


class HWEAgg(Aggregator):
    """hardy_weinberg_test(GT): het_freq_hwe + p_value (Levene-Haldane exact
    test; reference `is/hail/stats/LeveneHaldane.scala`)."""

    name = 'hardy_weinberg_test'
    _result_t = ht.tstruct(het_freq_hwe=ht.tfloat64, p_value=ht.tfloat64)

    def result_type(self, arg_types, init_args):
        return self._result_t

    def seq(self, arg_cols, include, axis, init_args):
        from ..genetics.call import calls_is_het, calls_is_hom_ref, calls_is_hom_var, PLOIDY_MASK
        (gt,) = arg_cols
        ok = _include_and_defined(gt, include)
        packed = np.broadcast_to(gt.values, ok.shape)
        diploid = (packed & PLOIDY_MASK) == 2
        n_hom_ref = np.sum(ok & diploid & calls_is_hom_ref(packed), axis=axis, dtype=np.int64)
        n_het = np.sum(ok & diploid & calls_is_het(packed), axis=axis, dtype=np.int64)
        n_hom_var = np.sum(ok & diploid & calls_is_hom_var(packed), axis=axis, dtype=np.int64)
        return (n_hom_ref, n_het, n_hom_var)

    def comb(self, a, b, init_args):
        return tuple(x + y for x, y in zip(a, b))

    def result(self, state, init_args):
        from ..stats.hwe import hwe_test_vec
        one_sided = bool(init_args[0]) if init_args else False
        n_hom_ref, n_het, n_hom_var = (np.atleast_1d(np.asarray(v)) for v in state)
        het_freq, p = hwe_test_vec(n_hom_ref, n_het, n_hom_var, one_sided=one_sided)
        shape = n_hom_ref.shape
        return StructColumn(self._result_t, {
            'het_freq_hwe': PrimitiveColumn(ht.tfloat64, het_freq),
            'p_value': PrimitiveColumn(ht.tfloat64, p),
        }, None, shape)


class InbreedingAgg(Aggregator):
    """inbreeding(GT, prior_af) → f_stat struct (reference
    `agg/InbreedingAggregator`)."""

    name = 'inbreeding'
    _result_t = ht.tstruct(f_stat=ht.tfloat64, n_called=ht.tint64,
                           expected_homs=ht.tfloat64, observed_homs=ht.tint64)

    def result_type(self, arg_types, init_args):
        return self._result_t

    def seq(self, arg_cols, include, axis, init_args):
        from ..genetics.call import calls_is_het
        gt, af = arg_cols
        ok = _include_and_defined(gt, include) & ~af.missing_mask()
        packed = np.broadcast_to(gt.values, ok.shape)
        afv = np.broadcast_to(np.asarray(af.values, dtype=np.float64), ok.shape)
        n_called = np.sum(ok, axis=axis, dtype=np.int64)
        expected = np.sum(np.where(ok, 1.0 - 2.0 * afv * (1.0 - afv), 0.0), axis=axis)
        observed = np.sum(ok & ~calls_is_het(packed), axis=axis, dtype=np.int64)
        return (n_called, expected, observed)

    def comb(self, a, b, init_args):
        return tuple(x + y for x, y in zip(a, b))

    def result(self, state, init_args):
        n_called, expected, observed = (np.atleast_1d(np.asarray(v)) for v in state)
        with np.errstate(all='ignore'):
            f = (observed - expected) / (n_called - expected)
        miss = n_called == 0
        return StructColumn(self._result_t, {
            'f_stat': PrimitiveColumn(ht.tfloat64, np.where(miss, 0.0, f), miss if miss.any() else None),
            'n_called': PrimitiveColumn(ht.tint64, n_called),
            'expected_homs': PrimitiveColumn(ht.tfloat64, expected),
            'observed_homs': PrimitiveColumn(ht.tint64, observed),
        }, None, n_called.shape)


class HistAgg(Aggregator):
    name = 'hist'

    def result_type(self, arg_types, init_args):
        return ht.tstruct(bin_edges=ht.tarray(ht.tfloat64), bin_freq=ht.tarray(ht.tint64),
                          n_smaller=ht.tint64, n_larger=ht.tint64)

    def seq(self, arg_cols, include, axis, init_args):
        (x,) = arg_cols
        start, end, bins = init_args
        ok = _include_and_defined(x, include)
        vals = np.broadcast_to(np.asarray(x.values, dtype=np.float64), ok.shape)
        ndim = len(ok.shape)
        assert len(axis) == ndim, 'hist supports full reduction only'
        v = vals[ok]
        n_smaller = int(np.sum(v < start))
        n_larger = int(np.sum(v > end))
        inb = v[(v >= start) & (v <= end)]
        idx = np.minimum(((inb - start) / (end - start) * bins).astype(np.int64), bins - 1)
        freq = np.bincount(idx, minlength=bins).astype(np.int64)
        return (freq, np.int64(n_smaller), np.int64(n_larger))

    def comb(self, a, b, init_args):
        return (a[0] + b[0], a[1] + b[1], a[2] + b[2])

    def result(self, state, init_args):
        start, end, bins = init_args
        freq, n_smaller, n_larger = state
        edges = list(np.linspace(start, end, bins + 1))
        return C.from_pylist(self.result_type([None], init_args), [Struct(
            bin_edges=edges, bin_freq=list(freq), n_smaller=int(n_smaller), n_larger=int(n_larger))])


class CorrAgg(Aggregator):
    name = 'corr'

    def result_type(self, arg_types, init_args):
        return ht.tfloat64

    def seq(self, arg_cols, include, axis, init_args):
        x, y = arg_cols
        ok = _include_and_defined(x, include) & ~y.missing_mask()
        xv = np.where(ok, np.broadcast_to(x.values, ok.shape), 0).astype(np.float64)
        yv = np.where(ok, np.broadcast_to(y.values, ok.shape), 0).astype(np.float64)
        return (np.sum(xv, axis=axis), np.sum(yv, axis=axis), np.sum(xv * xv, axis=axis),
                np.sum(yv * yv, axis=axis), np.sum(xv * yv, axis=axis),
                np.sum(ok, axis=axis, dtype=np.int64))

    def comb(self, a, b, init_args):
        return tuple(x + y for x, y in zip(a, b))

    def result(self, state, init_args):
        sx, sy, sxx, syy, sxy, n = (np.asarray(v, dtype=np.float64) for v in state)
        with np.errstate(all='ignore'):
            cov = sxy - sx * sy / n
            r = cov / np.sqrt((sxx - sx * sx / n) * (syy - sy * sy / n))
        miss = np.asarray(state[5]) < 2
        return PrimitiveColumn(ht.tfloat64, np.where(miss, 0.0, r), miss if miss.any() else None)


class LinRegAgg(Aggregator):
    """linreg(y, x...): per-group OLS via accumulated X^T·X / X^T·y moments
    (reference `agg/LinearRegressionAggregator`). Vectorized with einsum so an
    (R, C) entries block reduced over axis=1 produces (R, k, k) normal
    equations without python loops."""

    name = 'linreg'

    def result_type(self, arg_types, init_args):
        arr = ht.tarray(ht.tfloat64)
        return ht.tstruct(beta=arr, standard_error=arr, t_stat=arr, p_value=arr,
                          multiple_standard_error=ht.tfloat64,
                          multiple_r_squared=ht.tfloat64,
                          adjusted_r_squared=ht.tfloat64,
                          f_stat=ht.tfloat64, multiple_p_value=ht.tfloat64,
                          n=ht.tint64)

    def seq(self, arg_cols, include, axis, init_args):
        k, nested_dim = init_args[0], init_args[1]
        weighted = len(init_args) > 2 and init_args[2]
        y = arg_cols[0]
        xs = arg_cols[1:-1] if weighted else arg_cols[1:]
        ok = _include_and_defined(y, include)
        for x in xs:
            ok = ok & ~x.missing_mask()
        if weighted:
            wcol = arg_cols[-1]
            ok = ok & ~wcol.missing_mask()
        shape = ok.shape
        if weighted:
            w = np.where(ok, np.broadcast_to(
                np.asarray(wcol.values, np.float64), shape), 0.0)
        else:
            w = ok.astype(np.float64)
        yv = np.where(ok, np.broadcast_to(np.asarray(y.values, np.float64), shape), 0.0)
        X = np.stack([np.where(ok, np.broadcast_to(np.asarray(x.values, np.float64), shape), 0.0) for x in xs],
                     axis=-1)  # shape + (k,)
        # weighted normal equations: X'WX, X'Wy, y'Wy
        xtx = np.einsum('...i,...j->...ij', X * w[..., None], X)
        xtx = np.sum(xtx, axis=axis)
        xty = np.sum(X * (w * yv)[..., None], axis=axis)
        yty = np.sum(w * yv * yv, axis=axis)
        n = np.sum(ok, axis=axis, dtype=np.int64)
        return (xtx, xty, yty, n, nested_dim)

    def comb(self, a, b, init_args):
        return (a[0] + b[0], a[1] + b[1], a[2] + b[2], a[3] + b[3], a[4])

    def result(self, state, init_args):
        import scipy.stats as st
        xtx, xty, yty, n, nested_dim = state
        xtx = np.asarray(xtx, np.float64)
        scalar = xtx.ndim == 2
        if scalar:
            xtx = xtx[None]
            xty = np.asarray(xty)[None]
            yty = np.atleast_1d(np.asarray(yty))
            n = np.atleast_1d(np.asarray(n))
        R = xtx.shape[0]
        k = xtx.shape[-1]
        from ..utils.structs import Struct
        rows = []
        for i in range(R):
            ni = int(n[i])
            d = ni - k
            if ni == 0 or d <= 0:
                # no (or insufficient) data: all-missing stats, n kept
                rows.append(Struct(
                    beta=None, standard_error=None, t_stat=None, p_value=None,
                    multiple_standard_error=None, multiple_r_squared=None,
                    adjusted_r_squared=None, f_stat=None, multiple_p_value=None,
                    n=ni))
                continue
            try:
                beta = np.linalg.solve(xtx[i], xty[i])
                rss = float(yty[i] - xty[i] @ beta)
                sigma2 = rss / d
                cov = np.linalg.inv(xtx[i]) * sigma2
                se = np.sqrt(np.diag(cov))
                t = beta / se
                p = 2 * st.t.sf(np.abs(t), d)
                # null model = FIRST nested_dim covariates (reference
                # agg.linreg: the F-test compares the full model against the
                # model restricted to x[:nested_dim])
                if 0 < nested_dim < k:
                    xtx0 = xtx[i][:nested_dim, :nested_dim]
                    xty0 = xty[i][:nested_dim]
                    beta0 = np.linalg.solve(xtx0, xty0)
                    rss0 = float(yty[i] - xty0 @ beta0)
                else:
                    rss0 = float(yty[i])
                q = k - nested_dim if 0 < nested_dim < k else k
                f = ((rss0 - rss) / q) / (rss / d) if rss > 0 else float('nan')
                fp = float(st.f.sf(f, q, d)) if rss > 0 else float('nan')
                r2 = 1 - rss / rss0 if rss0 > 0 else float('nan')
                ar2 = 1 - (1 - r2) * (ni - nested_dim) / d if not math.isnan(r2) else r2
                rows.append(Struct(
                    beta=list(beta), standard_error=list(se), t_stat=list(t),
                    p_value=list(p), multiple_standard_error=math.sqrt(sigma2),
                    multiple_r_squared=r2, adjusted_r_squared=ar2,
                    f_stat=float(f), multiple_p_value=fp, n=ni))
            except np.linalg.LinAlgError:
                rows.append(None)
        return C.from_pylist(self.result_type([None], init_args), rows)


class InfoScoreAgg(Aggregator):
    """info_score(gp): IMPUTE-style imputation quality (reference
    `agg/InfoScoreAggregator`)."""

    name = 'info_score'
    _result_t = ht.tstruct(score=ht.tfloat64, n_included=ht.tint32)

    def result_type(self, arg_types, init_args):
        return self._result_t

    def seq(self, arg_cols, include, axis, init_args):
        (gp,) = arg_cols
        if isinstance(gp, DenseArrayColumn):
            ok = _include_and_defined(gp, include)
            v = gp.values.astype(np.float64)
            e = v[..., 1] + 2 * v[..., 2]
            f = v[..., 1] + 4 * v[..., 2]
            e = np.where(ok, e, 0.0)
            f = np.where(ok, f, 0.0)
            return (np.sum(e, axis=axis), np.sum(f, axis=axis),
                    np.sum(e * e, axis=axis),
                    np.sum(ok, axis=axis, dtype=np.int64))
        obj = C.to_object(gp)
        ok = _include_and_defined(gp, include)
        flat = obj.values.ravel()
        okf = ok.ravel()
        se = sf = se2 = 0.0
        cnt = 0
        for v, o in zip(flat, okf):
            if o and v is not None:
                ei = v[1] + 2 * v[2]
                se += ei
                sf += v[1] + 4 * v[2]
                se2 += ei * ei
                cnt += 1
        return (np.float64(se), np.float64(sf), np.float64(se2), np.int64(cnt))

    def comb(self, a, b, init_args):
        return tuple(x + y for x, y in zip(a, b))

    def result(self, state, init_args):
        # IMPUTE info (Marchini & Howie 2010 supplement):
        # 1 - sum_i(f_i - e_i^2) / (2 N theta (1 - theta)), theta = sum(e)/2N
        e, f, e2, n = (np.atleast_1d(np.asarray(v, np.float64)) for v in state)
        with np.errstate(all='ignore'):
            # empirically the engine's theta is the mean expected dosage
            # sum(e)/N (matches infoScoreTest.result), not sum(e)/2N
            theta = e / n
            info = 1 - (f - e2) / (2 * n * theta * (1 - theta))
            info = np.where((theta == 0) | (theta == 1), 1.0, info)
        miss = n == 0
        return StructColumn(self._result_t, {
            'score': PrimitiveColumn(ht.tfloat64, np.where(miss, 0.0, info), miss if miss.any() else None),
            'n_included': PrimitiveColumn(ht.tint32, n.astype(np.int32)),
        }, None, e.shape)


class ApproxCDFAgg(Aggregator):
    """approx_cdf(x, k): KLL quantile sketch (Karnin-Lang-Liberty) — bounded
    memory, mergeable, rank error O(1/k) (the reference implements the same
    sketch family in `agg/ApproxCDFAggregator.scala`).

    Level h holds items of weight 2^h with capacity k*(2/3)^(H-1-h) (min 8).
    An overflowing level is compacted: sorted, one random parity promoted to
    level h+1, the other discarded. Odd buffers keep one item in place so the
    total weight is EXACTLY n (ranks[-1] == n without fixups)."""

    name = 'approx_cdf'
    SHRINK = 2.0 / 3.0

    RAW_T = ht.tstruct(levels=ht.tarray(ht.tint32), items=ht.tarray(ht.tfloat64),
                       _compaction_counts=ht.tarray(ht.tint32))

    @staticmethod
    def _parse_init(init_args):
        if not init_args:
            return 100, False
        k = init_args[0]
        raw = bool(init_args[1]) if len(init_args) > 1 else False
        return k, raw

    def result_type(self, arg_types, init_args):
        _, raw = self._parse_init(init_args)
        if raw:
            return self.RAW_T
        return ht.tstruct(values=ht.tarray(ht.tfloat64), ranks=ht.tarray(ht.tint64),
                          _compaction_counts=ht.tarray(ht.tint32))

    def _cap(self, k, h, H):
        import math
        return max(int(math.ceil(k * (self.SHRINK ** (H - 1 - h)))), 8)

    def _compact(self, levels, counts, k, rng):
        while True:
            H = len(levels)
            over = None
            for h in range(H):
                if levels[h].size > self._cap(k, h, H):
                    over = h
                    break
            if over is None:
                return levels, counts
            buf = np.sort(levels[over])
            keep = np.empty(0, dtype=np.float64)
            if buf.size % 2 == 1:
                # keep one item at this level so total weight is preserved
                keep_idx = rng.integers(0, buf.size)
                keep = buf[keep_idx:keep_idx + 1]
                buf = np.delete(buf, keep_idx)
            promoted = buf[int(rng.integers(0, 2))::2]
            levels[over] = keep
            if over + 1 == H:
                levels.append(promoted)
                counts = counts + [0]
            else:
                levels[over + 1] = np.concatenate([levels[over + 1], promoted])
            counts[over] += 1

    def seq(self, arg_cols, include, axis, init_args):
        k, _ = self._parse_init(init_args)
        (x,) = arg_cols
        ok = _include_and_defined(x, include)
        vals = np.broadcast_to(np.asarray(x.values, np.float64), ok.shape)[ok]
        rng = np.random.default_rng(0x5EED ^ vals.size)
        levels = [np.asarray(vals, np.float64).ravel()]
        counts = [0]
        levels, counts = self._compact(levels, counts, k, rng)
        return (levels, counts, np.int64(vals.size))

    def comb(self, a, b, init_args):
        k, _ = self._parse_init(init_args)
        la, ca, na = a
        lb, cb, nb = b
        H = max(len(la), len(lb))
        levels = []
        counts = []
        for h in range(H):
            xs = [l[h] for l in (la, lb) if h < len(l)]
            levels.append(np.concatenate(xs) if len(xs) > 1 else xs[0].copy())
            counts.append((ca[h] if h < len(ca) else 0)
                          + (cb[h] if h < len(cb) else 0))
        rng = np.random.default_rng(0xC0B ^ int(na + nb))
        levels, counts = self._compact(levels, counts, k, rng)
        return (levels, counts, na + nb)

    def result(self, state, init_args):
        from ..utils.structs import Struct
        _, raw = self._parse_init(init_args)
        levels, counts, n = state
        if raw:
            # raw sketch: `levels` are offsets into `items`; items of level h
            # (weight 2^h) are items[levels[h]:levels[h+1]], sorted
            # (reference approx_cdf(_raw=True), ApproxCDFAggregator.scala)
            offsets = [0]
            parts = []
            for lvl in levels:
                parts.append(np.sort(lvl))
                offsets.append(offsets[-1] + lvl.size)
            items = np.concatenate(parts) if parts else np.empty(0)
            return C.from_pylist(self.RAW_T, [Struct(
                levels=[int(o) for o in offsets],
                items=[float(v) for v in items],
                _compaction_counts=[int(c) for c in counts])])
        vals = np.concatenate(levels) if levels else np.empty(0)
        w = np.concatenate([np.full(l.size, 1 << h, np.int64)
                            for h, l in enumerate(levels)]) if levels else \
            np.empty(0, np.int64)
        order = np.argsort(vals, kind='stable')
        vals, w = vals[order], w[order]
        ranks = np.concatenate([[0], np.cumsum(w)]).astype(np.int64)
        assert ranks.size == 1 or ranks[-1] == n, (ranks[-1], n)
        return C.from_pylist(self.result_type([None], init_args), [Struct(
            values=list(vals), ranks=list(ranks),
            _compaction_counts=[int(c) for c in counts])])


class DownsampleAgg(Aggregator):
    """downsample(x, y[, label], n_divisions): grid-based point thinning
    (reference `agg/DownsampleAggregator`)."""

    name = 'downsample'

    def result_type(self, arg_types, init_args):
        return ht.tarray(ht.ttuple(ht.tfloat64, ht.tfloat64, ht.tarray(ht.tstr)))

    def seq(self, arg_cols, include, axis, init_args):
        n_div, has_label = init_args
        x, y = arg_cols[0], arg_cols[1]
        lab = arg_cols[2] if has_label else None
        ok = _include_and_defined(x, include) & ~y.missing_mask()
        xv = np.broadcast_to(np.asarray(x.values, np.float64), ok.shape)[ok]
        yv = np.broadcast_to(np.asarray(y.values, np.float64), ok.shape)[ok]
        if lab is not None:
            lo = C.to_object(lab)
            lv_all = np.empty(int(np.prod(lo.shape)), dtype=object)
            for i, v in enumerate(np.asarray(lo.values, dtype=object).ravel()):
                lv_all[i] = v
            lv = np.broadcast_to(lv_all.reshape(lo.shape), ok.shape)[ok]
        else:
            lv = np.full(xv.shape, None, dtype=object)
        return {'pts': list(zip(xv.tolist(), yv.tolist(), lv.tolist()))}

    def comb(self, a, b, init_args):
        return {'pts': a['pts'] + b['pts']}

    def result(self, state, init_args):
        n_div, has_label = init_args
        pts = state['pts']
        if not pts:
            return C.from_pylist(self.result_type([None], init_args), [[]])
        xs = np.asarray([p[0] for p in pts])
        ys = np.asarray([p[1] for p in pts])
        x0, x1 = xs.min(), xs.max()
        y0, y1 = ys.min(), ys.max()
        xspan = (x1 - x0) or 1.0
        yspan = (y1 - y0) or 1.0
        grid = {}
        for (x, y, l) in pts:
            key = (int((x - x0) / xspan * n_div), int((y - y0) / yspan * n_div))
            if key not in grid:
                if l is None:
                    lab = None
                elif isinstance(l, (list, tuple)):
                    lab = [None if s is None else str(s) for s in l]
                else:
                    lab = [str(l)]
                grid[key] = (x, y, lab)
        return C.from_pylist(self.result_type([None], init_args), [list(grid.values())])


# ---------------------------------------------------------------------------
# Aggregation driver
# ---------------------------------------------------------------------------

def collect_agg_nodes(ir: IR) -> List[AggOp]:
    """All AggOp nodes in `ir` that are not nested inside another AggOp's args
    (nested aggs are not supported, as in the reference)."""
    out: List[AggOp] = []
    def rec(node):
        if isinstance(node, AggOp):
            out.append(node)
            return
        for c in node.children:
            rec(c)
    rec(ir)
    return out


def partial_aggregate(agg_nodes: Sequence[AggOp], env: EvalEnv,
                      axis: Tuple[int, ...],
                      extra_include: Optional[np.ndarray] = None) -> Dict[str, Any]:
    """Evaluate each aggregator's args in row context and produce partial
    states (the per-partition seqOp of the reference's RunAgg)."""
    states: Dict[str, Any] = {}
    for node in agg_nodes:
        include = extra_include
        if node.filter_ir is not None:
            fc = node.filter_ir.evaluate(env)
            fm = fc.missing_mask()
            fv = np.asarray(fc.values, dtype=bool) if isinstance(fc, PrimitiveColumn) else \
                np.asarray([v is True for v in C.to_object(fc).values.ravel()]).reshape(fc.shape)
            filt = np.broadcast_to(~fm & fv, env.shape)
            include = filt if include is None else (np.broadcast_to(include, env.shape) & filt)
        if hasattr(node.aggregator, 'seq_env'):
            states[node.uid] = node.aggregator.seq_env(node, env, axis, include)
            continue
        arg_cols = [a.evaluate(env) for a in node.args]
        if isinstance(node.aggregator, CountAgg):
            states[node.uid] = node.aggregator.seq(arg_cols, include, axis, node.init_args, shape=env.shape)
        else:
            # broadcast arg columns to env shape so reductions see full extent
            arg_cols = [c.broadcast_to(env.shape) if c.shape != env.shape else c for c in arg_cols]
            if include is not None and include.shape != env.shape:
                include = np.broadcast_to(include, env.shape)
            states[node.uid] = node.aggregator.seq(arg_cols, include, axis, node.init_args)
    return states


def combine_states(agg_nodes: Sequence[AggOp], s1: Dict[str, Any], s2: Dict[str, Any]) -> Dict[str, Any]:
    return {n.uid: n.aggregator.comb(s1[n.uid], s2[n.uid], n.init_args) for n in agg_nodes}


def finalize_aggregate(ir: IR, agg_nodes: Sequence[AggOp], states: Dict[str, Any],
                       post_env: EvalEnv) -> Column:
    results = {}
    for n in agg_nodes:
        if hasattr(n.aggregator, 'result_env'):
            col = n.aggregator.result_env(states[n.uid], post_env)
        else:
            col = n.aggregator.result(states[n.uid], n.init_args)
        if col.shape != post_env.shape and int(np.prod(col.shape)) == int(np.prod(post_env.shape)):
            col = col.reshape(post_env.shape)
        results[n.uid] = col
    post_ir = substitute_aggs(ir, results)
    return post_ir.evaluate(post_env)


# ---------------------------------------------------------------------------
# Scans (streaming exclusive prefix) — two-phase like the reference
# (`LowerTableIR.scala:1607-1660`): per-partition totals, exclusive prefix of
# carries across partitions, then a vectorized within-partition prefix.
# ---------------------------------------------------------------------------

def scan_partition(node: AggOp, env: EvalEnv, carry) -> Tuple[Column, Any]:
    """Evaluate a scan within one partition: per-row EXCLUSIVE prefix results
    given `carry` (the combined state of all prior partitions, or None).
    Returns (result column of shape env.shape, carry_out)."""
    agg_ = node.aggregator
    arg_cols = [a.evaluate(env) for a in node.args]
    arg_cols = [c.broadcast_to(env.shape) if c.shape != env.shape else c for c in arg_cols]
    include = None
    if node.filter_ir is not None:
        fc = node.filter_ir.evaluate(env)
        fv = np.asarray(fc.values, dtype=bool) if isinstance(fc, PrimitiveColumn) else \
            np.asarray([v is True for v in C.to_object(fc).values.ravel()]).reshape(fc.shape)
        include = np.broadcast_to(~fc.missing_mask() & fv, env.shape)
    n = env.shape[0]

    def excl(a, zero=0):
        out = np.roll(a, 1, axis=0)
        if out.shape[0]:
            out[0] = zero
        return out

    if isinstance(agg_, CountAgg):
        inc = (include if include is not None else np.ones(n, dtype=bool)).astype(np.int64)
        cum = excl(np.cumsum(inc))
        base = carry if carry is not None else 0
        col = PrimitiveColumn(ht.tint64, base + cum)
        return col, (base + int(inc.sum()))
    if isinstance(agg_, DensifyAgg):
        x, lcol = arg_cols
        outs, state = agg_._run(x, lcol, carry)
        rt = agg_.result_type([a.typ for a in node.args], node.init_args)
        return C.from_pylist(rt, list(outs)).reshape(env.shape), state
    if isinstance(agg_, CountWhereAgg):
        (cond,) = arg_cols
        ok = _include_and_defined(cond, include)
        vals = ok & np.asarray(cond.values, dtype=bool)
        cum = excl(np.cumsum(vals.astype(np.int64)))
        base = carry if carry is not None else 0
        return PrimitiveColumn(ht.tint64, base + cum), base + int(vals.sum())
    if isinstance(agg_, MeanAgg):
        (x,) = arg_cols
        ok = _include_and_defined(x, include)
        vals = np.where(ok, np.asarray(x.values), 0).astype(np.float64)
        cum_s = excl(np.cumsum(vals), 0.0)
        cum_n = excl(np.cumsum(ok.astype(np.int64)))
        cs, cn = carry if carry is not None else (0.0, 0)
        tot = (cs + vals.sum(), cn + int(ok.sum()))
        with np.errstate(all='ignore'):
            m = (cs + cum_s) / (cn + cum_n)
        miss = (cn + cum_n) == 0
        return PrimitiveColumn(ht.tfloat64, np.where(miss, 0.0, m),
                               miss if miss.any() else None), tot
    if isinstance(agg_, SumAgg) and not isinstance(agg_, ArraySumAgg):
        (x,) = arg_cols
        ok = _include_and_defined(x, include)
        dt = np.int64 if x.typ in (ht.tint32, ht.tint64, ht.tbool) else np.float64
        vals = np.where(ok, np.asarray(x.values), 0).astype(dt)
        cum_s = excl(np.cumsum(vals), dt(0))
        cs = carry if carry is not None else dt(0)
        tot = cs + vals.sum()
        t = ht.tint64 if dt == np.int64 else ht.tfloat64
        return PrimitiveColumn(t, cs + cum_s), tot
    if isinstance(agg_, MinMaxAgg):
        (x,) = arg_cols
        ok = _include_and_defined(x, include)
        fill = np.inf if agg_.is_min else -np.inf
        xv = np.asarray(x.values, dtype=np.float64)
        ok = ok & ~np.isnan(xv)
        vals = np.where(ok, xv, fill)
        acc = np.minimum.accumulate(vals) if agg_.is_min else np.maximum.accumulate(vals)
        acc = excl(acc, fill)
        seen = excl(np.cumsum(ok.astype(np.int64))) > 0
        if carry is not None:
            cv, cseen, _ctyp = carry
            acc = np.minimum(acc, cv) if agg_.is_min else np.maximum(acc, cv)
            seen = seen | bool(cseen)
        part_v = float(np.min(vals, initial=fill)) if agg_.is_min else float(np.max(vals, initial=-np.inf if not agg_.is_min else fill))
        if carry is not None:
            part_v = min(part_v, float(carry[0])) if agg_.is_min else max(part_v, float(carry[0]))
        tot = (np.asarray(part_v), np.asarray(bool(ok.any()) or bool(carry[1] if carry is not None else False)), x.typ)
        t = x.typ
        out = acc.astype(t.numpy_dtype) if t.numpy_dtype is not None else acc
        miss = ~seen
        return PrimitiveColumn(t, np.where(miss, 0, out).astype(t.numpy_dtype),
                               miss if miss.any() else None), tot
    if isinstance(agg_, CollectAgg) and agg_.kind == 'collect':
        (x,) = arg_cols
        ok = _include_and_defined(x, include)
        pyl = C.obj_array(_flatten_vals(x), x.shape)
        prefix = list(carry) if carry is not None else []
        out = np.empty(n, dtype=object)
        for i in range(n):
            out[i] = list(prefix)
            if ok[i]:
                prefix.append(pyl[i])
        return ObjectColumn(node.typ, out), prefix
    # generic fallback: sequential seq/comb per row (correct, slow).
    # Env-combinators (group_by/explode/array_agg/fold) take row-sliced envs
    # instead of arg columns.
    env_aware = hasattr(agg_, 'seq_env')

    def env_rows(idxs):
        b = {k: c.broadcast_to(env.shape).gather(np.asarray(idxs, dtype=np.int64))
             for k, c in env.bindings.items()}
        return EvalEnv(b, (len(idxs),))

    states = []
    carry_state = carry
    for i in range(n):
        states.append(carry_state)
        inc = include[i:i + 1] if include is not None else None
        if env_aware:
            s = agg_.seq_env(node, env_rows([i]), (0,), inc)
        else:
            row_cols = [c.gather(np.asarray([i])) for c in arg_cols]
            s = agg_.seq(row_cols, inc, (0,), node.init_args)
        carry_state = s if carry_state is None else agg_.comb(carry_state, s, node.init_args)
    results = []
    for i, st_ in enumerate(states):
        if st_ is None:
            if env_aware:
                st_ = agg_.seq_env(node, env_rows([]), (0,), None)
            else:
                empty_cols = [c.gather(np.asarray([], dtype=np.int64)) for c in arg_cols]
                st_ = agg_.seq(empty_cols, None, (0,), node.init_args)
        if env_aware:
            # finalize with THIS row's env: the combinator's inner IR may
            # reference row fields outside the aggregated part
            col = agg_.result_env(st_, env_rows([i]))
        else:
            col = agg_.result(st_, node.init_args)
        results.append(col.to_pylist()[0])
    return C.from_pylist(node.typ, results), carry_state


def combine_optional(agg_nodes, a, b):
    if a is None:
        return b
    if b is None:
        return a
    return combine_states(agg_nodes, a, b)


# ---------------------------------------------------------------------------
# Combinator aggregators (env-aware): group_by / explode / array_agg / fold
# (reference `agg/GroupedAggregator`, `AggExplode`, `AggArrayPerElement`,
# `AggFold` — `is/hail/expr/ir/agg/`).
# ---------------------------------------------------------------------------

class _SlicedStates:
    """Per-slice states of an env-combinator aggregated over a PARTIAL axis
    set (e.g. per-row aggregation over entries): one full-reduction state per
    kept index. Cross-partition comb zips slice-wise, which is correct for
    the only partial context that combines across partitions (column-wise
    aggregation — slices are columns, consistent across row partitions)."""

    __slots__ = ('states',)

    def __init__(self, states):
        self.states = states


def _slice_env(env: EvalEnv, ka: int, i: int) -> EvalEnv:
    """Project a 2-D env onto slice i of axis ka, dropping that axis."""
    bindings = {}
    for k, c in env.bindings.items():
        sliced = c
        if len(c.shape) == len(env.shape):
            if c.shape[ka] == env.shape[ka] and env.shape[ka] != 1:
                sliced = c.gather(np.asarray([i], dtype=np.int64), axis=ka)
            new_shape = tuple(s for d, s in enumerate(sliced.shape) if d != ka)
            sliced = sliced.reshape(new_shape)
        bindings[k] = sliced
    new_shape = tuple(s for d, s in enumerate(env.shape) if d != ka)
    return EvalEnv(bindings, new_shape)


class EnvCombinator(Aggregator):
    """Shared machinery for group_by/explode/array_agg/fold: subclasses
    implement `_seq_env_full` (full-reduction), `_comb_full`, and
    `_result_one`; partial-axis contexts (annotate_rows/annotate_cols entry
    aggregations) are lifted by slicing the kept axis — the reference
    supports these combinators in any context (`agg/Extract.scala:26-146`)."""

    def seq_env(self, node, env, axis, include):
        if len(axis) == len(env.shape):
            return self._seq_env_full(node, env, axis, include)
        if len(env.shape) != 2 or len(axis) != 1:
            raise NotImplementedError(
                f'agg.{self.name}: unsupported aggregation context '
                f'(shape {env.shape}, axis {axis})')
        ka = 1 - axis[0]
        inc = None if include is None else np.broadcast_to(include, env.shape)
        states = []
        for i in range(env.shape[ka]):
            senv = _slice_env(env, ka, i)
            sinc = None if inc is None else np.take(inc, i, axis=ka)
            states.append(self._seq_env_full(
                node, senv, tuple(range(len(senv.shape))), sinc))
        return _SlicedStates(states)

    def comb(self, a, b, init_args):
        if isinstance(a, _SlicedStates):
            assert isinstance(b, _SlicedStates) and len(a.states) == len(b.states)
            return _SlicedStates([self._comb_full(x, y, init_args)
                                  for x, y in zip(a.states, b.states)])
        return self._comb_full(a, b, init_args)

    def result_env(self, state, post_env):
        if isinstance(state, _SlicedStates):
            vals = []
            for st_ in state.states:
                col = self._result_one(st_, post_env)
                v = col.to_pylist()
                vals.append(v[0] if v else None)
            return C.from_pylist(self.result_type(None, None), vals)
        return self._result_one(state, post_env)


class GroupedAgg(EnvCombinator):
    name = 'group_by'

    def __init__(self, key_ir, inner_ir, inner_nodes, key_t, value_t):
        self.key_ir = key_ir
        self.inner_ir = inner_ir
        self.inner_nodes = inner_nodes
        self.key_t = key_t
        self.value_t = value_t

    def result_type(self, arg_types, init_args):
        return ht.tdict(self.key_t, self.value_t)

    def _seq_env_full(self, node, env, axis, include):
        key_col = self.key_ir.evaluate(env)
        if key_col.shape != env.shape:
            key_col = key_col.broadcast_to(env.shape)
        keys = C.obj_array(_flatten_vals(key_col)).reshape(env.shape)
        # a missing key is its own group (reference GroupedAggregator)
        base_ok = np.ones(env.shape, dtype=bool)
        if include is not None:
            base_ok = base_ok & np.broadcast_to(include, env.shape)
        out = {}
        flat_keys = keys.ravel()
        flat_ok = base_ok.ravel()
        from ..utils.structs import freeze
        uniq = {}
        for i, k in enumerate(flat_keys):
            if flat_ok[i]:
                uniq.setdefault(freeze(k), []).append(i)
        for k, idxs in uniq.items():
            mask = np.zeros(env.shape, dtype=bool)
            mask.ravel()[idxs] = True
            out[k] = partial_aggregate(self.inner_nodes, env, axis, extra_include=mask)
        return out

    def _comb_full(self, a, b, init_args):
        out = dict(a)
        for k, st_ in b.items():
            out[k] = combine_states(self.inner_nodes, out[k], st_) if k in out else st_
        return out

    def _result_one(self, state, post_env):
        d = {}
        for k, st_ in state.items():
            col = finalize_aggregate(self.inner_ir, self.inner_nodes, st_,
                                     EvalEnv(dict(post_env.bindings), (1,)))
            vals = col.to_pylist()
            d[k] = vals[0] if vals else None
        from functools import cmp_to_key
        from ..expr.functions import _cmp_values
        d = dict(sorted(d.items(),
                        key=cmp_to_key(lambda x, y: _cmp_values(x[0], y[0]))))
        return C.from_pylist(ht.tdict(self.key_t, self.value_t), [frozendict(d)])


class ExplodedAgg(EnvCombinator):
    name = 'explode'

    def __init__(self, arr_ir, var, inner_ir, inner_nodes, value_t):
        self.arr_ir = arr_ir
        self.var = var
        self.inner_ir = inner_ir
        self.inner_nodes = inner_nodes
        self.value_t = value_t

    def result_type(self, arg_types, init_args):
        return self.value_t

    def _seq_env_full(self, node, env, axis, include):
        arr_col = self.arr_ir.evaluate(env)
        if arr_col.shape != env.shape:
            arr_col = arr_col.broadcast_to(env.shape)
        obj = C.to_object(arr_col)
        flat = obj.values.ravel()
        ok = np.ones(flat.size, dtype=bool) if include is None else \
            np.broadcast_to(include, env.shape).ravel()
        rep_idx = []
        elem_idx = []
        elems = []
        for i, v in enumerate(flat):
            if v is None or not ok[i]:
                continue
            seq = sorted(v, key=lambda x: (x is None, x)) if isinstance(v, (set, frozenset)) else list(v)
            for j, x in enumerate(seq):
                rep_idx.append(i)
                elem_idx.append(j)
                elems.append(x)
        n = len(elems)
        et = self.arr_ir.typ.element_type
        idx = np.asarray(rep_idx, dtype=np.int64)
        new_bindings = {}
        for k2, c in env.bindings.items():
            fc = c.reshape((int(np.prod(c.shape)),)) if int(np.prod(c.shape)) == int(np.prod(env.shape)) \
                else c.broadcast_to(env.shape).reshape((int(np.prod(env.shape)),))
            new_bindings[k2] = fc.gather(idx)
        # exploded elements extend the uid words with their index within the
        # row's collection (reference AggExplode stream-uid appending)
        ej = np.asarray(elem_idx, dtype=np.int64)
        k3 = 0
        while f'__uid_w{k3}__' in new_bindings:
            k3 += 1
        if k3 == 0 and '__row_idx__' in new_bindings:
            new_bindings['__uid_w0__'] = PrimitiveColumn(
                ht.tint64, np.asarray(new_bindings['__row_idx__'].values,
                                      dtype=np.int64).ravel().copy())
            k3 = 1
        new_bindings[f'__uid_w{k3}__'] = PrimitiveColumn(ht.tint64, ej)
        new_bindings[self.var] = C.from_pylist(et, elems)
        inner_env = EvalEnv(new_bindings, (n,))
        return partial_aggregate(self.inner_nodes, inner_env, (0,))

    def _comb_full(self, a, b, init_args):
        return combine_states(self.inner_nodes, a, b)

    def _result_one(self, state, post_env):
        return finalize_aggregate(self.inner_ir, self.inner_nodes, state,
                                  EvalEnv(dict(post_env.bindings), (1,)))


class ArrayAggAgg(EnvCombinator):
    name = 'array_agg'

    def __init__(self, arr_ir, var, inner_ir, inner_nodes, value_t):
        self.arr_ir = arr_ir
        self.var = var
        self.inner_ir = inner_ir
        self.inner_nodes = inner_nodes
        self.value_t = value_t

    def result_type(self, arg_types, init_args):
        return ht.tarray(self.value_t)

    def _seq_env_full(self, node, env, axis, include):
        arr_col = self.arr_ir.evaluate(env)
        if arr_col.shape != env.shape:
            arr_col = arr_col.broadcast_to(env.shape)
        et = self.arr_ir.typ.element_type
        obj = C.to_object(arr_col)
        inc0 = None if include is None else np.broadcast_to(include, env.shape).ravel()
        n_records = sum(1 for i, _ in enumerate(obj.values.ravel())
                        if inc0 is None or inc0[i])
        if n_records == 0:
            # no aggregated records at all: the result is missing
            # (reference AggArrayPerElement over an empty stream)
            return None
        lengths = [len(v) for v in obj.values.ravel() if v is not None]
        if lengths and len(set(lengths)) > 1:
            from ..utils.misc import FatalError
            raise FatalError('array_agg: arrays must have identical lengths')
        width = lengths[0] if lengths else 0
        states = []
        for j in range(width):
            flat = obj.values.ravel()
            elems = [None if v is None else v[j] for v in flat]
            new_bindings = {k2: c.broadcast_to(env.shape).reshape((len(flat),))
                            for k2, c in env.bindings.items()}
            new_bindings[self.var] = C.from_pylist(et, elems)
            inner_env = EvalEnv(new_bindings, (len(flat),))
            inc = None if include is None else np.broadcast_to(include, env.shape).ravel()
            states.append(partial_aggregate(self.inner_nodes, inner_env, (0,), extra_include=inc))
        return states

    def _comb_full(self, a, b, init_args):
        if a is None:
            return b
        if b is None:
            return a
        if len(a) < len(b):
            a, b = b, a
        return [combine_states(self.inner_nodes, x, y) for x, y in zip(a, b)] + list(a[len(b):])

    def _result_one(self, state, post_env):
        if state is None:
            return C.from_pylist(ht.tarray(self.value_t), [None])
        vals = []
        for st_ in state:
            col = finalize_aggregate(self.inner_ir, self.inner_nodes, st_,
                                     EvalEnv(dict(post_env.bindings), (1,)))
            v = col.to_pylist()
            vals.append(v[0] if v else None)
        return C.from_pylist(ht.tarray(self.value_t), [vals])


class FoldAgg(EnvCombinator):
    name = 'fold'

    def __init__(self, zero_ir, accum_name, seq_ir, comb_name1, comb_name2, comb_ir, value_t):
        self.zero_ir = zero_ir
        self.accum_name = accum_name
        self.seq_ir = seq_ir
        self.comb_name1 = comb_name1
        self.comb_name2 = comb_name2
        self.comb_ir = comb_ir
        self.value_t = value_t

    def result_type(self, arg_types, init_args):
        return self.value_t

    def _zero(self, env):
        col = self.zero_ir.evaluate(EvalEnv({k: v for k, v in env.bindings.items()
                                             if k == 'global'}, (1,)))
        v = col.to_pylist()
        return v[0] if v else None

    def _seq_env_full(self, node, env, axis, include):
        n = int(np.prod(env.shape))
        flat_env_bindings = {k: c.broadcast_to(env.shape).reshape((n,))
                             for k, c in env.bindings.items()}
        inc = None if include is None else np.broadcast_to(include, env.shape).ravel()
        acc = self._zero(env)
        for i in range(n):
            if inc is not None and not inc[i]:
                continue
            bindings = {k: c.gather(np.asarray([i])) for k, c in flat_env_bindings.items()}
            bindings[self.accum_name] = C.from_pylist(self.value_t, [acc])
            res = self.seq_ir.evaluate(EvalEnv(bindings, (1,)))
            v = res.to_pylist()
            acc = v[0] if v else None
        return acc

    def _comb_full(self, a, b, init_args):
        bindings = {self.comb_name1: C.from_pylist(self.value_t, [a]),
                    self.comb_name2: C.from_pylist(self.value_t, [b])}
        res = self.comb_ir.evaluate(EvalEnv(bindings, (1,)))
        v = res.to_pylist()
        return v[0] if v else None

    def _result_one(self, state, post_env):
        return C.from_pylist(self.value_t, [state])

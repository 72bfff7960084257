"""Columnar value plane: vectorized columns with missing masks.

This is the columnar replacement for the reference's Region/PType/UnsafeRow
off-heap row plane (`is/hail/annotations/`, `types/physical/`): a partition
materializes to a `Batch` of columns. Numeric/bool/call columns are numpy
arrays (1-D for table rows, 2-D `(n_rows, n_cols)` for matrix entries);
missingness is an explicit bool mask (True = missing), mirroring Hail's
3-valued semantics. Strings and nested values fall back to object columns;
fixed-width arrays (AD/PL) get a dense representation suitable for device
transfer.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import types as ht
from ..utils.structs import Interval, Struct, frozendict
from ..genetics.call import Call
from ..genetics.locus import Locus


# ---------------------------------------------------------------------------
# Column hierarchy
# ---------------------------------------------------------------------------

_STRICT_INVARIANTS = False


def set_strict_invariants(on: bool) -> None:
    """Toggle strict-invariants mode (flag 'strict_invariants'): every Batch
    construction validates the columnar plane's structural invariants — the
    analogue of the reference's region-integrity / requiredness assertions
    (`HailFeatureFlags` + region `assert`s). Synced from the session flags by
    hail_tpu.context."""
    global _STRICT_INVARIANTS
    _STRICT_INVARIANTS = bool(on)


class InvariantViolation(AssertionError):
    pass


def _inv(cond: bool, path: str, msg: str) -> None:
    if not cond:
        raise InvariantViolation(f'{path}: {msg}')


class Column:
    """Abstract column: values of one HailType with shape (n,) or (r, c)."""

    typ: ht.HailType
    shape: Tuple[int, ...]

    @property
    def length(self) -> int:
        return self.shape[0]

    # -- structural ops ----------------------------------------------------
    def gather(self, indices: np.ndarray, axis: int = 0) -> 'Column':
        raise NotImplementedError

    def compress(self, keep: np.ndarray, axis: int = 0) -> 'Column':
        raise NotImplementedError

    def slice(self, start: int, stop: int, axis: int = 0) -> 'Column':
        idx = np.arange(start, stop)
        return self.gather(idx, axis)

    def broadcast_to(self, shape: Tuple[int, ...]) -> 'Column':
        raise NotImplementedError

    def missing_mask(self) -> np.ndarray:
        """bool array (True = missing) of self.shape."""
        raise NotImplementedError

    def with_missing(self, missing: Optional[np.ndarray]) -> 'Column':
        """Replace/merge the missing mask."""
        raise NotImplementedError

    def to_pylist(self) -> list:
        """Convert to nested python values (None for missing)."""
        raise NotImplementedError

    # -- helpers -----------------------------------------------------------
    def reshape(self, shape) -> 'Column':
        raise NotImplementedError

    def check_invariants(self, path: str = '<column>') -> None:
        """Validate structural invariants (strict_invariants mode)."""
        pass


def obj_array(values, shape=None) -> np.ndarray:
    """Build a 1-D object ndarray from python values WITHOUT numpy's nested-
    sequence inference (lists of equal-length lists must stay one element
    per row)."""
    arr = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        arr[i] = v
    return arr if shape is None else arr.reshape(shape)


def _merge_missing(a: Optional[np.ndarray], b: Optional[np.ndarray]) -> Optional[np.ndarray]:
    if a is None:
        return b
    if b is None:
        return a
    return a | b


def _bcast(arr: Optional[np.ndarray], shape) -> Optional[np.ndarray]:
    if arr is None:
        return None
    return np.broadcast_to(arr, shape)


class PrimitiveColumn(Column):
    """int32/int64/float32/float64/bool/call values as a numpy array."""

    __slots__ = ('typ', 'values', 'missing', 'shape')

    def __init__(self, typ: ht.HailType, values: np.ndarray, missing: Optional[np.ndarray] = None):
        values = np.asarray(values)
        if typ.numpy_dtype is not None and values.dtype != typ.numpy_dtype:
            values = values.astype(typ.numpy_dtype)
        self.typ = typ
        self.values = values
        if missing is not None:
            missing = np.asarray(missing, dtype=bool)
            if missing.shape != values.shape:
                missing = np.broadcast_to(missing, values.shape)
            if not missing.any():
                missing = None
        self.missing = missing
        self.shape = values.shape

    def gather(self, indices, axis=0):
        v = np.take(self.values, indices, axis=axis)
        m = np.take(self.missing, indices, axis=axis) if self.missing is not None else None
        return PrimitiveColumn(self.typ, v, m)

    def compress(self, keep, axis=0):
        v = np.compress(keep, self.values, axis=axis)
        m = np.compress(keep, self.missing, axis=axis) if self.missing is not None else None
        return PrimitiveColumn(self.typ, v, m)

    def broadcast_to(self, shape):
        return PrimitiveColumn(self.typ, np.broadcast_to(self.values, shape), _bcast(self.missing, shape))

    def missing_mask(self):
        if self.missing is None:
            return np.zeros(self.shape, dtype=bool)
        return self.missing

    def with_missing(self, missing):
        return PrimitiveColumn(self.typ, self.values, _merge_missing(self.missing, missing))

    def reshape(self, shape):
        m = self.missing.reshape(shape) if self.missing is not None else None
        return PrimitiveColumn(self.typ, self.values.reshape(shape), m)

    def check_invariants(self, path='<column>'):
        _inv(self.values.shape == self.shape, path,
             f'values shape {self.values.shape} != column shape {self.shape}')
        if self.typ.numpy_dtype is not None:
            _inv(self.values.dtype == self.typ.numpy_dtype, path,
                 f'values dtype {self.values.dtype} != {self.typ} dtype '
                 f'{self.typ.numpy_dtype}')
        if self.missing is not None:
            _inv(self.missing.dtype == np.bool_, path, 'missing mask not bool')
            _inv(self.missing.shape == self.shape, path,
                 f'missing shape {self.missing.shape} != {self.shape}')
            _inv(bool(self.missing.any()), path,
                 'all-False missing mask should be normalized to None')

    def to_pylist(self):
        flat_v = self.values.ravel()
        flat_m = self.missing.ravel() if self.missing is not None else None
        is_call = self.typ == ht.tcall
        out = []
        for i in range(flat_v.size):
            if flat_m is not None and flat_m[i]:
                out.append(None)
            elif is_call:
                out.append(Call.from_packed(int(flat_v[i])))
            else:
                out.append(flat_v[i].item())
        return _nest(out, self.shape)


class DeferredPrimitiveColumn(PrimitiveColumn):
    """A PrimitiveColumn whose data is a pending device→host fetch
    (ops/fetchgroup.py): `xform(slot_host_array)` → (values, missing) runs on
    first data access, after the stage's single batched d2h. Construction and
    shape queries stay lazy — partition functions return Batches whose
    columns are fetched once per stage, not once per partition. The `values`/
    `missing` properties shadow the parent's slots, so every inherited
    method resolves transparently and isinstance(PrimitiveColumn) holds."""

    __slots__ = ('_slot', '_xform', '_resolved')

    def __init__(self, typ: ht.HailType, n: int, slot, xform):
        self.typ = typ
        self.shape = (n,)
        self._slot = slot
        self._xform = xform
        self._resolved = None

    def _col(self) -> PrimitiveColumn:
        if self._resolved is None:
            values, missing = self._xform(self._slot.get())
            self._resolved = PrimitiveColumn(self.typ, values, missing)
            self._slot = self._xform = None
        return self._resolved

    @property
    def values(self):
        return self._col().values

    @property
    def missing(self):
        return self._col().missing


class StructColumn(Column):
    __slots__ = ('typ', 'fields', 'missing', 'shape')

    def __init__(self, typ: ht.tstruct, fields: Dict[str, Column], missing: Optional[np.ndarray] = None,
                 shape: Optional[Tuple[int, ...]] = None):
        self.typ = typ
        self.fields = dict(fields)
        if shape is None:
            if fields:
                shape = next(iter(fields.values())).shape
            else:
                raise ValueError('empty struct column requires explicit shape')
        self.shape = shape
        if missing is not None:
            missing = np.asarray(missing, dtype=bool)
            if not missing.any():
                missing = None
        self.missing = missing

    def gather(self, indices, axis=0):
        f = {k: c.gather(indices, axis) for k, c in self.fields.items()}
        m = np.take(self.missing, indices, axis=axis) if self.missing is not None else None
        shape = list(self.shape)
        shape[axis] = len(indices)
        return StructColumn(self.typ, f, m, tuple(shape))

    def compress(self, keep, axis=0):
        f = {k: c.compress(keep, axis) for k, c in self.fields.items()}
        m = np.compress(keep, self.missing, axis=axis) if self.missing is not None else None
        shape = list(self.shape)
        shape[axis] = int(np.count_nonzero(keep))
        return StructColumn(self.typ, f, m, tuple(shape))

    def broadcast_to(self, shape):
        f = {k: c.broadcast_to(shape) for k, c in self.fields.items()}
        return StructColumn(self.typ, f, _bcast(self.missing, shape), shape)

    def missing_mask(self):
        if self.missing is None:
            return np.zeros(self.shape, dtype=bool)
        return self.missing

    def with_missing(self, missing):
        return StructColumn(self.typ, self.fields, _merge_missing(self.missing, missing), self.shape)

    def reshape(self, shape):
        f = {k: c.reshape(shape) for k, c in self.fields.items()}
        m = self.missing.reshape(shape) if self.missing is not None else None
        return StructColumn(self.typ, f, m, shape)

    def check_invariants(self, path='<column>'):
        if self.missing is not None:
            _inv(self.missing.shape == self.shape, path,
                 f'missing shape {self.missing.shape} != {self.shape}')
        for k, c in self.fields.items():
            _inv(c.shape == self.shape, f'{path}.{k}',
                 f'field shape {c.shape} != struct shape {self.shape}')
            c.check_invariants(f'{path}.{k}')

    def to_pylist(self):
        field_lists = {k: obj_array(_flatten(c.to_pylist(), len(c.shape))) for k, c in self.fields.items()}
        n = int(np.prod(self.shape)) if self.shape else 1
        flat_m = self.missing.ravel() if self.missing is not None else None
        out = []
        for i in range(n):
            if flat_m is not None and flat_m[i]:
                out.append(None)
            else:
                out.append(Struct(**{k: v[i] for k, v in field_lists.items()}))
        return _nest(out, self.shape)


class LocusColumn(Column):
    """Loci as (contig_index:int32, position:int32) against a reference genome.

    Ordering/interval ops use the int64 global position (reference:
    `is/hail/variant/Locus.scala` ordering by contig index then position).
    """

    __slots__ = ('typ', 'contig_idx', 'position', 'missing', 'shape')

    def __init__(self, typ: ht.tlocus, contig_idx: np.ndarray, position: np.ndarray,
                 missing: Optional[np.ndarray] = None):
        self.typ = typ
        self.contig_idx = np.asarray(contig_idx, dtype=np.int32)
        self.position = np.asarray(position, dtype=np.int32)
        if missing is not None:
            missing = np.asarray(missing, dtype=bool)
            if not missing.any():
                missing = None
        self.missing = missing
        self.shape = self.contig_idx.shape

    @property
    def rg(self):
        return self.typ.reference_genome

    def global_position(self) -> np.ndarray:
        if self.rg is None:
            # genome-less loci (reference: rg=None keys are a plain
            # contig/position struct): order by contig index then position
            return ((self.contig_idx.astype(np.int64) << np.int64(33))
                    + self.position.astype(np.int64))
        offsets = np.asarray([self.rg._global_offsets[c] for c in self.rg.contigs], dtype=np.int64)
        return offsets[self.contig_idx] + (self.position.astype(np.int64) - 1)

    def gather(self, indices, axis=0):
        m = np.take(self.missing, indices, axis=axis) if self.missing is not None else None
        return LocusColumn(self.typ, np.take(self.contig_idx, indices, axis=axis),
                           np.take(self.position, indices, axis=axis), m)

    def compress(self, keep, axis=0):
        m = np.compress(keep, self.missing, axis=axis) if self.missing is not None else None
        return LocusColumn(self.typ, np.compress(keep, self.contig_idx, axis=axis),
                           np.compress(keep, self.position, axis=axis), m)

    def broadcast_to(self, shape):
        return LocusColumn(self.typ, np.broadcast_to(self.contig_idx, shape),
                           np.broadcast_to(self.position, shape), _bcast(self.missing, shape))

    def missing_mask(self):
        if self.missing is None:
            return np.zeros(self.shape, dtype=bool)
        return self.missing

    def with_missing(self, missing):
        return LocusColumn(self.typ, self.contig_idx, self.position, _merge_missing(self.missing, missing))

    def reshape(self, shape):
        m = self.missing.reshape(shape) if self.missing is not None else None
        return LocusColumn(self.typ, self.contig_idx.reshape(shape), self.position.reshape(shape), m)

    def check_invariants(self, path='<column>'):
        _inv(self.position.shape == self.shape, path,
             f'position shape {self.position.shape} != {self.shape}')
        _inv(self.contig_idx.dtype == np.int32 and self.position.dtype == np.int32,
             path, 'locus contig_idx/position must be int32')
        if self.rg is not None and self.contig_idx.size:
            live = self.contig_idx if self.missing is None \
                else self.contig_idx[~self.missing]
            if live.size:
                _inv(int(live.min()) >= 0 and int(live.max()) < len(self.rg.contigs),
                     path, 'contig index out of range for reference genome')

    def to_pylist(self):
        contigs = self.rg.contigs
        flat_c = self.contig_idx.ravel()
        flat_p = self.position.ravel()
        flat_m = self.missing.ravel() if self.missing is not None else None
        out = []
        for i in range(flat_c.size):
            if flat_m is not None and flat_m[i]:
                out.append(None)
            else:
                out.append(Locus(contigs[int(flat_c[i])], int(flat_p[i]), self.rg))
        return _nest(out, self.shape)


class DenseArrayColumn(Column):
    """Fixed-max-width arrays of primitives: values (*shape, width), per-element
    lengths, and an element-missing mask. Used for AD/PL-style entry fields so
    they remain dense tensors suitable for device transfer (SURVEY §7: pad row
    blocks; dense-block + mask)."""

    __slots__ = ('typ', 'values', 'lengths', 'elem_missing', 'missing', 'shape')

    def __init__(self, typ: ht.tarray, values: np.ndarray, lengths: np.ndarray,
                 elem_missing: Optional[np.ndarray] = None, missing: Optional[np.ndarray] = None):
        self.typ = typ
        self.values = np.asarray(values)
        self.lengths = np.asarray(lengths, dtype=np.int32)
        self.elem_missing = elem_missing
        if missing is not None:
            missing = np.asarray(missing, dtype=bool)
            if not missing.any():
                missing = None
        self.missing = missing
        self.shape = self.lengths.shape

    @property
    def width(self) -> int:
        return self.values.shape[-1]

    def gather(self, indices, axis=0):
        return DenseArrayColumn(
            self.typ,
            np.take(self.values, indices, axis=axis),
            np.take(self.lengths, indices, axis=axis),
            np.take(self.elem_missing, indices, axis=axis) if self.elem_missing is not None else None,
            np.take(self.missing, indices, axis=axis) if self.missing is not None else None,
        )

    def compress(self, keep, axis=0):
        return DenseArrayColumn(
            self.typ,
            np.compress(keep, self.values, axis=axis),
            np.compress(keep, self.lengths, axis=axis),
            np.compress(keep, self.elem_missing, axis=axis) if self.elem_missing is not None else None,
            np.compress(keep, self.missing, axis=axis) if self.missing is not None else None,
        )

    def broadcast_to(self, shape):
        vshape = tuple(shape) + (self.width,)
        return DenseArrayColumn(
            self.typ,
            np.broadcast_to(self.values, vshape),
            np.broadcast_to(self.lengths, shape),
            np.broadcast_to(self.elem_missing, vshape) if self.elem_missing is not None else None,
            _bcast(self.missing, shape),
        )

    def missing_mask(self):
        if self.missing is None:
            return np.zeros(self.shape, dtype=bool)
        return self.missing

    def with_missing(self, missing):
        return DenseArrayColumn(self.typ, self.values, self.lengths, self.elem_missing,
                                _merge_missing(self.missing, missing))

    def reshape(self, shape):
        vshape = tuple(shape) + (self.width,)
        return DenseArrayColumn(
            self.typ, self.values.reshape(vshape), self.lengths.reshape(shape),
            self.elem_missing.reshape(vshape) if self.elem_missing is not None else None,
            self.missing.reshape(shape) if self.missing is not None else None)

    def index(self, i: np.ndarray) -> Column:
        """Vectorized arr[i]; out-of-bounds or element-missing → missing."""
        i = np.asarray(i)
        n = self.width
        if n == 0:
            shape = np.broadcast_shapes(self.shape, i.shape)
            et = self.typ.element_type
            z = np.zeros(shape, dtype=et.numpy_dtype or np.float64)
            return PrimitiveColumn(et, z, np.ones(shape, dtype=bool))
        ii = np.clip(np.where(i < 0, i + self.lengths, i), 0, max(n - 1, 0))
        v = np.take_along_axis(self.values, ii[..., None], axis=-1)[..., 0]
        oob = (np.where(i < 0, i + self.lengths, i) >= self.lengths) | (np.where(i < 0, i + self.lengths, i) < 0)
        m = oob
        if self.elem_missing is not None:
            m = m | np.take_along_axis(self.elem_missing, ii[..., None], axis=-1)[..., 0]
        m = _merge_missing(self.missing, m)
        return PrimitiveColumn(self.typ.element_type, v, m)

    def check_invariants(self, path='<column>'):
        _inv(self.values.shape == tuple(self.shape) + (self.width,), path,
             f'values shape {self.values.shape} != {tuple(self.shape) + (self.width,)}')
        _inv(self.lengths.shape == self.shape, path,
             f'lengths shape {self.lengths.shape} != {self.shape}')
        if self.lengths.size:
            live = self.lengths if self.missing is None \
                else self.lengths[~self.missing]
            if live.size:
                _inv(int(live.min()) >= 0 and int(live.max()) <= self.width,
                     path, f'array lengths outside [0, width={self.width}]')
        if self.elem_missing is not None:
            _inv(self.elem_missing.shape == self.values.shape, path,
                 f'elem_missing shape {self.elem_missing.shape} != '
                 f'{self.values.shape}')

    def to_pylist(self):
        et = self.typ.element_type
        if self.width == 0:
            flat_m = self.missing.ravel() if self.missing is not None else None
            out = [None if (flat_m is not None and flat_m[i]) else []
                   for i in range(int(np.prod(self.shape)))]
            return _nest(out, self.shape)
        flat_v = self.values.reshape(-1, self.width)
        flat_l = self.lengths.ravel()
        flat_em = self.elem_missing.reshape(-1, self.width) if self.elem_missing is not None else None
        flat_m = self.missing.ravel() if self.missing is not None else None
        is_call = et == ht.tcall
        out = []
        for i in range(flat_l.size):
            if flat_m is not None and flat_m[i]:
                out.append(None)
                continue
            row = []
            for j in range(int(flat_l[i])):
                if flat_em is not None and flat_em[i, j]:
                    row.append(None)
                elif is_call:
                    row.append(Call.from_packed(int(flat_v[i, j])))
                else:
                    row.append(flat_v[i, j].item())
            out.append(row)
        return _nest(out, self.shape)


class ObjectColumn(Column):
    """Fallback: arbitrary python values in an object ndarray; None = missing."""

    __slots__ = ('typ', 'values', 'shape')

    def __init__(self, typ: ht.HailType, values: np.ndarray):
        values = np.asarray(values, dtype=object)
        self.typ = typ
        self.values = values
        self.shape = values.shape

    def gather(self, indices, axis=0):
        return ObjectColumn(self.typ, np.take(self.values, indices, axis=axis))

    def compress(self, keep, axis=0):
        return ObjectColumn(self.typ, np.compress(keep, self.values, axis=axis))

    def broadcast_to(self, shape):
        return ObjectColumn(self.typ, np.broadcast_to(self.values, shape))

    def missing_mask(self):
        return np.frompyfunc(lambda x: x is None, 1, 1)(self.values).astype(bool)

    def with_missing(self, missing):
        if missing is None:
            return self
        v = self.values.copy()
        v[missing] = None
        return ObjectColumn(self.typ, v)

    def reshape(self, shape):
        return ObjectColumn(self.typ, self.values.reshape(shape))

    def to_pylist(self):
        return _nest(list(self.values.ravel()), self.shape)


class DeferredObjectColumn(ObjectColumn):
    """An ObjectColumn whose values materialize on first access: `build()`
    → np object array (None = missing). Lets heavy per-row payloads (e.g.
    the firth fit structs with their n-length mu vectors) exist in a result
    table's schema at zero cost until something actually reads them — the
    reference gets the same effect from relational field pruning before
    lowering."""

    __slots__ = ('_build', '_vals')

    def __init__(self, typ: ht.HailType, n: int, build):
        self.typ = typ
        self.shape = (n,)
        self._build = build
        self._vals = None

    @property
    def values(self):
        if self._vals is None:
            v = np.asarray(self._build(), dtype=object)
            assert v.shape == self.shape, (v.shape, self.shape)
            self._vals = v
            self._build = None
        return self._vals


def _nest(flat: list, shape: Tuple[int, ...]) -> list:
    """Reshape a flat python list into nested lists matching `shape`."""
    if len(shape) <= 1:
        return flat
    r, c = shape[0], int(np.prod(shape[1:]))
    return [_nest(flat[i * c:(i + 1) * c], shape[1:]) for i in range(r)]


# ---------------------------------------------------------------------------
# Constructors
# ---------------------------------------------------------------------------

def null_column(typ: ht.HailType, shape: Tuple[int, ...]) -> Column:
    """All-missing column of `typ`."""
    missing = np.ones(shape, dtype=bool)
    if typ.numpy_dtype is not None:
        return PrimitiveColumn(typ, np.zeros(shape, dtype=typ.numpy_dtype), missing)
    if isinstance(typ, ht.tstruct):
        return StructColumn(typ, {k: null_column(t, shape) for k, t in typ.fields.items()}, missing, shape)
    if isinstance(typ, ht.tlocus):
        return LocusColumn(typ, np.zeros(shape, np.int32), np.ones(shape, np.int32), missing)
    return ObjectColumn(typ, np.full(shape, None, dtype=object))


def const_column(typ: ht.HailType, value: Any, shape: Tuple[int, ...]) -> Column:
    if value is None:
        return null_column(typ, shape)
    return from_pylist(typ, [value]).broadcast_to(shape) if shape != (1,) else from_pylist(typ, [value])


def from_pylist(typ: ht.HailType, values: Sequence[Any]) -> Column:
    """Build a column from python values (None = missing)."""
    n = len(values)
    missing = np.asarray([v is None for v in values], dtype=bool)
    any_missing = bool(missing.any())
    if typ == ht.tcall:
        packed = np.asarray([0 if v is None else (v.packed if isinstance(v, Call) else int(v)) for v in values],
                            dtype=np.int32)
        return PrimitiveColumn(typ, packed, missing if any_missing else None)
    if typ.numpy_dtype is not None:
        vals = np.asarray([typ.numpy_dtype.type(0) if v is None else v for v in values], dtype=typ.numpy_dtype)
        return PrimitiveColumn(typ, vals, missing if any_missing else None)
    if isinstance(typ, ht.tlocus):
        rg = typ.reference_genome
        cidx = np.asarray([0 if v is None else rg.contig_index(v.contig) for v in values], dtype=np.int32)
        pos = np.asarray([1 if v is None else v.position for v in values], dtype=np.int32)
        return LocusColumn(typ, cidx, pos, missing if any_missing else None)
    if isinstance(typ, ht.tstruct):
        fields = {}
        for k, t in typ.fields.items():
            fields[k] = from_pylist(t, [None if v is None else _struct_get(v, k) for v in values])
        return StructColumn(typ, fields, missing if any_missing else None, (n,))
    if isinstance(typ, ht.tarray) and typ.element_type.numpy_dtype is not None:
        # dense fixed-width representation
        widths = [len(v) for v in values if v is not None]
        w = max(widths) if widths else 0
        et = typ.element_type
        vals = np.zeros((n, w), dtype=et.numpy_dtype)
        lengths = np.zeros(n, dtype=np.int32)
        elem_missing = np.zeros((n, w), dtype=bool)
        for i, v in enumerate(values):
            if v is None:
                continue
            lengths[i] = len(v)
            for j, x in enumerate(v):
                if x is None:
                    elem_missing[i, j] = True
                elif et == ht.tcall:
                    vals[i, j] = x.packed if isinstance(x, Call) else int(x)
                else:
                    vals[i, j] = x
        em = elem_missing if elem_missing.any() else None
        return DenseArrayColumn(typ, vals, lengths, em, missing if any_missing else None)
    arr = np.empty(n, dtype=object)
    for i, v in enumerate(values):
        arr[i] = v
    return ObjectColumn(typ, arr)


def _struct_get(v: Any, k: str) -> Any:
    if isinstance(v, (Struct, dict)):
        return v.get(k) if hasattr(v, 'get') else v[k]
    return getattr(v, k)


def concat_columns(cols: Sequence[Column], axis: int = 0) -> Column:
    """Concatenate same-typed columns along an axis."""
    cols = list(cols)
    assert cols
    if len(cols) == 1:
        return cols[0]
    c0 = cols[0]
    if isinstance(c0, PrimitiveColumn):
        vals = np.concatenate([c.values for c in cols], axis=axis)
        if any(c.missing is not None for c in cols):
            miss = np.concatenate([c.missing_mask() for c in cols], axis=axis)
        else:
            miss = None
        return PrimitiveColumn(c0.typ, vals, miss)
    if isinstance(c0, LocusColumn):
        ci = np.concatenate([c.contig_idx for c in cols], axis=axis)
        pos = np.concatenate([c.position for c in cols], axis=axis)
        miss = (np.concatenate([c.missing_mask() for c in cols], axis=axis)
                if any(c.missing is not None for c in cols) else None)
        return LocusColumn(c0.typ, ci, pos, miss)
    if isinstance(c0, StructColumn):
        fields = {k: concat_columns([c.fields[k] for c in cols], axis) for k in c0.fields}
        miss = (np.concatenate([c.missing_mask() for c in cols], axis=axis)
                if any(c.missing is not None for c in cols) else None)
        shape = list(c0.shape)
        shape[axis] = sum(c.shape[axis] for c in cols)
        return StructColumn(c0.typ, fields, miss, tuple(shape))
    if isinstance(c0, DenseArrayColumn):
        if all(isinstance(c, DenseArrayColumn) for c in cols):
            w = max(c.width for c in cols)
            vals, ems = [], []
            for c in cols:
                v = c.values
                em = c.elem_missing if c.elem_missing is not None else np.zeros(v.shape, bool)
                if c.width < w:
                    pad = [(0, 0)] * (v.ndim - 1) + [(0, w - c.width)]
                    v = np.pad(v, pad)
                    em = np.pad(em, pad, constant_values=False)
                vals.append(v)
                ems.append(em)
            miss = (np.concatenate([c.missing_mask() for c in cols], axis=axis)
                    if any(c.missing is not None for c in cols) else None)
            em_all = np.concatenate(ems, axis=axis)
            return DenseArrayColumn(
                c0.typ, np.concatenate(vals, axis=axis),
                np.concatenate([c.lengths for c in cols], axis=axis),
                em_all if em_all.any() else None, miss)
    # object fallback
    objs = []
    for c in cols:
        if isinstance(c, ObjectColumn):
            objs.append(c.values)
        else:
            objs.append(np.asarray(c.to_pylist(), dtype=object))
    return ObjectColumn(c0.typ, np.concatenate(objs, axis=axis))


def to_object(col: Column) -> ObjectColumn:
    if isinstance(col, ObjectColumn):
        return col
    flat = _flatten(col.to_pylist(), len(col.shape))
    arr = obj_array(flat, col.shape)
    return ObjectColumn(col.typ, arr)


def _flatten(nested, depth):
    if depth <= 1:
        return nested
    out = []
    for x in nested:
        out.extend(_flatten(x, depth - 1))
    return out


# ---------------------------------------------------------------------------
# Batch: a materialized partition
# ---------------------------------------------------------------------------

class Batch:
    """A materialized table partition: ordered field → Column, common length."""

    __slots__ = ('columns', 'length')

    def __init__(self, columns: Dict[str, Column], length: Optional[int] = None):
        self.columns = dict(columns)
        if length is None:
            if not self.columns:
                raise ValueError('empty batch requires explicit length')
            length = next(iter(self.columns.values())).length
        self.length = length
        if _STRICT_INVARIANTS:
            self.check_invariants()

    def check_invariants(self) -> None:
        """Validate every column's structure + the common-length contract
        (strict_invariants mode)."""
        for k, c in self.columns.items():
            _inv(isinstance(c, Column), k, f'not a Column: {type(c).__name__}')
            _inv(len(c.shape) >= 1 and c.shape[0] == self.length, k,
                 f'column shape {c.shape} vs batch length {self.length}')
            c.check_invariants(k)

    @property
    def row_type(self) -> ht.tstruct:
        return ht.tstruct(**{k: c.typ for k, c in self.columns.items()})

    def select(self, names) -> 'Batch':
        return Batch({k: self.columns[k] for k in names}, self.length)

    def annotate(self, **cols: Column) -> 'Batch':
        d = dict(self.columns)
        d.update(cols)
        return Batch(d, self.length)

    def drop(self, *names) -> 'Batch':
        return Batch({k: v for k, v in self.columns.items() if k not in names}, self.length)

    def gather(self, indices) -> 'Batch':
        return Batch({k: c.gather(indices) for k, c in self.columns.items()}, len(indices))

    def compress(self, keep) -> 'Batch':
        n = int(np.count_nonzero(keep))
        return Batch({k: c.compress(keep) for k, c in self.columns.items()}, n)

    def slice(self, start, stop) -> 'Batch':
        start = max(0, min(start, self.length))
        stop = max(start, min(stop, self.length))
        return Batch({k: c.slice(start, stop) for k, c in self.columns.items()}, stop - start)

    def to_pylist(self) -> List[Struct]:
        cols = {k: c.to_pylist() for k, c in self.columns.items()}
        return [Struct(**{k: cols[k][i] for k in self.columns}) for i in range(self.length)]

    @staticmethod
    def concat(batches: Sequence['Batch']) -> 'Batch':
        batches = [b for b in batches]
        assert batches
        if len(batches) == 1:
            return batches[0]
        keys = list(batches[0].columns.keys())
        return Batch(
            {k: concat_columns([b.columns[k] for b in batches]) for k in keys},
            sum(b.length for b in batches),
        )

    @staticmethod
    def from_pylist(row_type: ht.tstruct, rows: Sequence[Any]) -> 'Batch':
        cols = {}
        for k, t in row_type.fields.items():
            cols[k] = from_pylist(t, [None if r is None else _struct_get(r, k) for r in rows])
        return Batch(cols, len(rows))

    @staticmethod
    def empty(row_type: ht.tstruct) -> 'Batch':
        return Batch({k: null_column(t, (0,)) for k, t in row_type.fields.items()}, 0)

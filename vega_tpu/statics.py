"""Static-array store: large model constants as jit arguments.

Closed-over numpy constants get embedded as literals in the serialized
HLO. For this framework that means hundreds of MB (dense FFTLog
operators, inverse covariances, distortion/metal matrices), which bloats
compile payloads and duplicates device memory. The store keeps every
large constant exactly once (content-deduplicated — e.g. the FFTLog
operators shared by all ~16 tracer pairs hash to one entry), ships it to
the device once, and passes the whole collection as one replicated pytree
argument to the jitted likelihood.

Usage:
    ref = STATICS.register(big_numpy_array)   # at init (host)
    ...
    resolve(ref)                               # inside compute code
    with STATICS.bind(traced_tree):            # while tracing
        ...

Outside a bind() scope resolve() returns the host numpy array, so the
same compute code runs eagerly for debugging and golden-value tests.
"""

from __future__ import annotations

import hashlib
import threading
from contextlib import contextmanager

import numpy as np

# Arrays below this element count stay inline jit constants.
INLINE_THRESHOLD = 16384


class StaticRef:
    """Handle to a registered static array."""

    __slots__ = ('store', 'name', 'shape', 'dtype')

    def __init__(self, store, name, shape, dtype):
        self.store = store
        self.name = name
        self.shape = shape
        self.dtype = dtype

    def __repr__(self):
        return f'StaticRef({self.name}, {self.shape}, {self.dtype})'


class StaticStore:
    def __init__(self):
        self._arrays = {}
        self._device_arrays = None
        self._device_x64 = None
        self._by_hash = {}
        self._local = threading.local()

    def register(self, arr, hint=''):
        """Register an array; returns a StaticRef for large arrays or the
        array itself when it is small enough to inline."""
        arr = np.asarray(arr)
        if arr.size < INLINE_THRESHOLD:
            return arr
        key = (arr.shape, str(arr.dtype),
               hashlib.sha1(arr.tobytes()).hexdigest())
        name = self._by_hash.get(key)
        if name is None:
            name = f's{len(self._arrays)}' + (f'_{hint}' if hint else '')
            self._by_hash[key] = name
            self._arrays[name] = arr
            self._device_arrays = None  # invalidate device cache
        return StaticRef(self, name, arr.shape, arr.dtype)

    def host_tree(self):
        """The full store as host numpy arrays (e.g. to place a
        reference evaluation on another backend)."""
        return dict(self._arrays)

    def device_tree(self):
        """The full store as a dict of device arrays (cached; one H2D
        transfer per array and precision mode: toggling jax_enable_x64
        in-process re-places the store in the new working dtype)."""
        import jax
        x64 = bool(jax.config.jax_enable_x64)
        if self._device_arrays is None or self._device_x64 != x64:
            import jax.numpy as jnp
            self._device_arrays = {name: jnp.asarray(arr)
                                   for name, arr in self._arrays.items()}
            self._device_x64 = x64
        return self._device_arrays

    @contextmanager
    def bind(self, tree):
        """Bind a (possibly traced) tree for the duration of a trace."""
        prev = getattr(self._local, 'bound', None)
        self._local.bound = tree
        try:
            yield
        finally:
            self._local.bound = prev

    def lookup(self, ref: StaticRef):
        bound = getattr(self._local, 'bound', None)
        if bound is not None and ref.name in bound:
            return bound[ref.name]
        return self._arrays[ref.name]

    def nbytes(self):
        return sum(a.nbytes for a in self._arrays.values())


STATICS = StaticStore()


def register(arr, hint=''):
    return STATICS.register(arr, hint)


def resolve(x):
    """StaticRef -> (traced or host) array; anything else passes through."""
    if isinstance(x, StaticRef):
        return x.store.lookup(x)
    return x


def is_identity(arr, tol=0.0):
    """True if a square matrix is exactly the identity (used to skip
    identity distortion/metal matmuls that the reference performs
    literally, e.g. model.py:143 on eye matrices)."""
    arr = np.asarray(arr)
    if arr.ndim != 2 or arr.shape[0] != arr.shape[1]:
        return False
    if tol == 0.0:
        expected = np.eye(arr.shape[0], dtype=arr.dtype)
        return np.array_equal(arr, expected)
    return np.allclose(arr, np.eye(arr.shape[0]), atol=tol)

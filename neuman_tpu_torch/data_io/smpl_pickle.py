"""Reader of the SMPL fits `smpl_output_{romp,optimized}.pkl`, which
preprocessing writes with `joblib.dump`, without joblib (the GPU machine
has none).

A joblib file is a pickle stream in which each numpy array is replaced by
a `joblib.numpy_pickle.NumpyArrayWrapper` object (subclass, shape, order,
dtype, ...) whose BUILD opcode is followed, outside the pickle stream, by
the array's bytes: since joblib 1.2 a 1-byte padding length and that many
padding bytes first (the wrapper then has `numpy_array_alignment_bytes`),
then the raw data in the wrapper's order ("C" or "F"). An array of Python
objects is a nested pickle at that place instead. `load` reads such a
stream as joblib's NumpyUnpickler does, and plain pickles too; a
compressed joblib file raises. `dump` writes a plain pickle, which both
`load` and `joblib.load` read.
"""

import io
import pickle

import numpy as np

# magic numbers of the compressors joblib can write
_COMPRESSED = {b"\x78\x01": "zlib", b"\x78\x5e": "zlib", b"\x78\x9c": "zlib",
               b"\x78\xda": "zlib", b"\x1f\x8b": "gzip", b"BZ": "bz2", b"\xfd7zXZ": "xz",
               b"]\x00\x00": "lzma", b"\x04\x22\x4d\x18": "lz4"}


class _ArrayWrapper:
    """Stands in for joblib.numpy_pickle.NumpyArrayWrapper: BUILD fills
    its __dict__ with the array's metadata."""

    def read(self, fh):
        if self.dtype.hasobject:
            return pickle.load(fh)
        if getattr(self, "numpy_array_alignment_bytes", None) is not None:
            padding = fh.read(1)[0]
            fh.read(padding)
        count = int(np.prod(self.shape, dtype=np.int64))
        data = fh.read(count * self.dtype.itemsize)
        if len(data) != count * self.dtype.itemsize:
            raise ValueError("joblib array data ends early")
        array = np.frombuffer(data, dtype=self.dtype, count=count).copy()
        if self.order == "F":
            array = array.reshape(self.shape[::-1]).transpose()
        else:
            array = array.reshape(self.shape)
        if not array.dtype.isnative:  # as joblib.load: in the machine's byte order
            array = array.byteswap().view(array.dtype.newbyteorder("="))
        return array


class _Unpickler(pickle._Unpickler):
    dispatch = pickle._Unpickler.dispatch.copy()

    def __init__(self, fh):
        super().__init__(fh)
        self._fh = fh

    def find_class(self, module, name):
        if module.endswith("joblib.numpy_pickle"):
            if name == "NumpyArrayWrapper":
                return _ArrayWrapper
            raise pickle.UnpicklingError(f"unsupported joblib object {module}.{name} (a file "
                                         "of joblib <= 0.9, with arrays in separate files)")
        return super().find_class(module, name)

    def load_build(self):
        pickle._Unpickler.load_build(self)
        if isinstance(self.stack[-1], _ArrayWrapper):
            self.stack.append(self.stack.pop().read(self._fh))

    dispatch[pickle.BUILD[0]] = load_build


def load(path):
    """The object a `joblib.dump` (uncompressed) or a `pickle.dump` wrote."""
    with open(path, "rb") as f:
        data = f.read()
    for magic, name in _COMPRESSED.items():
        if data.startswith(magic):
            raise ValueError(f"{path} is a {name}-compressed joblib file; this reader takes "
                             "uncompressed ones (joblib.dump(..., compress=0))")
    return _Unpickler(io.BytesIO(data)).load()


def dump(obj, path):
    """Write `obj` (dicts, lists and numpy arrays) as a plain pickle."""
    with open(path, "wb") as f:
        pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)

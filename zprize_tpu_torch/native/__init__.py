"""Native host helper: the order-sensitive plookup `combine_split` over
(n, 32)-byte little-endian rows (`hostops.c`, a verbatim copy of the JAX
package's), compiled with `gcc` on first use and loaded with ctypes.

The library is built into `<repo>/.torch_ext/hostops-<hash of the
source>/`, never beside the source. There is no fallback: if `gcc` or the
library is missing, the call raises and names the path.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "hostops.c")
REPO_DIR = os.path.dirname(os.path.dirname(_DIR))

_lib = None


def library_path():
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(REPO_DIR, ".torch_ext", f"hostops-{digest}",
                        "libhostops.so")


def _build(so):
    gcc = shutil.which("gcc")
    if gcc is None:
        raise RuntimeError(f"gcc not found: cannot build {so} from {_SRC}")
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f"{so}.tmp{os.getpid()}"
    r = subprocess.run([gcc, "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
                       capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"gcc failed to build {so} ({r.returncode}):\n"
                           f"{r.stderr}")
    os.replace(tmp, so)


def get_lib():
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not os.path.exists(so):
        _build(so)
    try:
        lib = ctypes.CDLL(so)
    except OSError as e:
        raise RuntimeError(f"cannot load {so}: {e}") from e
    lib.combine_split.restype = ctypes.c_int
    lib.combine_split.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_char_p]
    _lib = lib
    return lib


def combine_split_bytes(t_bytes: bytes, f_bytes: bytes, n: int):
    """combine_split over n 32-byte LE rows of t and f. Returns the (h1, h2)
    byte buffers; raises ValueError if f is not a sub-multiset of t."""
    if len(t_bytes) != 32 * n or len(f_bytes) != 32 * n:
        raise ValueError("t and f must hold n rows of 32 bytes")
    lib = get_lib()
    h1 = ctypes.create_string_buffer(n * 32)
    h2 = ctypes.create_string_buffer(n * 32)
    rc = lib.combine_split(t_bytes, f_bytes, n, h1, h2)
    if rc != 0:
        why = ": an element of f is not in t" if rc == -1 else ""
        raise ValueError(f"combine_split failed rc={rc}{why}")
    return h1.raw, h2.raw

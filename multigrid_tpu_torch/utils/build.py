"""Build the package's CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` file is compiled on its own by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes``. A
library lives in ``multigrid_tpu_torch/_build/<key>/``, where the key hashes
the source and the flags, so an edited source is rebuilt and an unchanged
one is built once. Several sources build in parallel, one ``nvcc`` each.

Nothing here runs at import time: the package imports where no CUDA
toolkit is installed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / 'csrc'
BUILD_DIR = PACKAGE_DIR / '_build'

NVCC_FLAGS = (
    '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
    '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
)

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, ``PATH``."""
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if root and os.path.isfile(os.path.join(root, 'bin', 'nvcc')):
            return os.path.join(root, 'bin', 'nvcc')
    found = shutil.which('nvcc')
    if found is None:
        raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA toolkit')
    return found


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    digest = hashlib.sha256((CSRC_DIR / source).read_bytes())
    digest.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / digest.hexdigest()[:16] / f'lib{Path(source).stem}.so'


def build(sources: list[str]) -> dict[str, Path]:
    """Build every source whose library is missing, all in parallel.

    Returns ``{source: library path}``. The compiler's output (registers,
    shared memory and spills from ``-Xptxas -v``) is kept beside each
    library as ``build.log``. Raises if any build fails.
    """
    paths = {s: library_path(s) for s in sources}
    running = []
    for src, lib in paths.items():
        if lib.exists():
            continue
        lib.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=lib.parent)
        os.close(fd)
        log = open(lib.parent / 'build.log', 'w')
        cmd = [nvcc(), *NVCC_FLAGS, '-o', tmp, str(CSRC_DIR / src)]
        running.append((src, lib, tmp, log,
                        subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for src, lib, tmp, log, proc in running:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, lib)
        else:
            os.unlink(tmp)
            failed.append(f'{src}:\n' + (lib.parent / 'build.log').read_text())
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return paths


def build_log(source: str) -> str:
    """The compiler output kept from building ``source`` ('' if none)."""
    log = library_path(source).parent / 'build.log'
    return log.read_text() if log.exists() else ''


def load(source: str) -> ctypes.CDLL:
    """The library built from ``csrc/<source>``, building it at first use."""
    if source not in _loaded:
        _loaded[source] = ctypes.CDLL(str(build([source])[source]))
    return _loaded[source]

"""Build the package's CUDA sources into shared libraries and load them.

Each ``csrc/*.cu`` file is compiled on its own by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes``. A
library lives in ``multigrid_tpu_torch/_build/<key>/``, where the key hashes
the source, the ``csrc`` headers it includes (``#include "x.cuh"``, followed
through the headers) and the flags, so an edited source or header is rebuilt
and an unchanged one is built once. Several sources build in parallel, one ``nvcc`` each.

Nothing here runs at import time: the package imports where no CUDA
toolkit is installed.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / 'csrc'
BUILD_DIR = PACKAGE_DIR / '_build'

NVCC_FLAGS = (
    '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
    '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v',
)

_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

_loaded: dict[str, ctypes.CDLL] = {}


def _tool(name: str) -> str:
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if root and os.path.isfile(os.path.join(root, 'bin', name)):
            return os.path.join(root, 'bin', name)
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f'{name} not found: the CUDA kernels need the CUDA toolkit')
    return found


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, ``PATH``."""
    return _tool('nvcc')


def sources_of(source: str) -> list[str]:
    """``source`` and the ``csrc`` files it includes, each once, in the
    order first included."""
    seen, todo = [], [source]
    while todo:
        name = todo.pop(0)
        if name not in seen:
            seen.append(name)
            todo += [m.decode() for m in _INCLUDE.findall((CSRC_DIR / name).read_bytes())]
    return seen


def library_path(source: str) -> Path:
    """Where the library built from ``csrc/<source>`` lives."""
    digest = hashlib.sha256()
    for name in sources_of(source):
        digest.update(name.encode() + b'\0' + (CSRC_DIR / name).read_bytes())
    digest.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / digest.hexdigest()[:16] / f'lib{Path(source).stem}.so'


def build(sources: list[str]) -> dict[str, Path]:
    """Build every source whose library is missing, all in parallel.

    Returns ``{source: library path}``. The compiler's output (registers,
    shared memory and spills from ``-Xptxas -v``) and the seconds nvcc took
    are kept beside each library as ``build.log``. Raises if any build
    fails.
    """
    paths = {s: library_path(s) for s in sources}
    todo = [(s, lib) for s, lib in paths.items() if not lib.exists()]
    if todo:
        with ThreadPoolExecutor(max_workers=len(todo)) as pool:
            failed = [f for f in pool.map(lambda t: _compile(*t), todo) if f]
        if failed:
            raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return paths


def _compile(source: str, lib: Path) -> str:
    """One nvcc run from ``csrc/<source>`` to ``lib``; returns '' or, if it
    failed, the source's name and the compiler's output."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=lib.parent)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, '-o', tmp, str(CSRC_DIR / source)],
                          capture_output=True, text=True)
    log = f'{proc.stdout}{proc.stderr}nvcc took {time.perf_counter() - t0:.2f} s\n'
    (lib.parent / 'build.log').write_text(log)
    if proc.returncode:
        os.unlink(tmp)
        return f'{source}:\n{log}'
    os.replace(tmp, lib)
    return ''


def build_log(source: str) -> str:
    """The compiler output kept from building ``source`` ('' if none)."""
    log = library_path(source).parent / 'build.log'
    return log.read_text() if log.exists() else ''


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PROPERTIES = re.compile(r'Function properties for (\S+)')
_SPILLS = re.compile(r'(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads')
_REGISTERS = re.compile(r'Used (\d+) registers')


def resource_usage(source: str) -> dict[str, dict[str, int]]:
    """``{kernel: {'registers', 'stack', 'spill_stores', 'spill_loads'}}``
    for every kernel of ``source``'s library, from what ``-Xptxas -v``
    printed when it was built (its ``build.log``)."""
    usage, kernel, props = {}, None, None
    for line in build_log(source).splitlines():
        if m := _ENTRY.search(line):
            kernel = m.group(1)
            usage[kernel] = {}
        elif m := _PROPERTIES.search(line):
            props = m.group(1)
        elif kernel and props == kernel and (m := _SPILLS.search(line)):
            usage[kernel].update(zip(('stack', 'spill_stores', 'spill_loads'),
                                     map(int, m.groups())))
        elif kernel and (m := _REGISTERS.search(line)):
            usage[kernel]['registers'] = int(m.group(1))
            kernel = None
    return usage


_SASS_FUNCTION = re.compile(r'Function : (\S+)')
_TENSOR_OP = re.compile(r'\b(?:HGMMA|HMMA)\.[\w.]+')


def tensor_core_ops(source: str) -> dict[str, set[str]]:
    """``{kernel: tensor-core instructions (HMMA, HGMMA) in its SASS}`` for
    every kernel of the library built from ``csrc/<source>``, read with
    ``cuobjdump -sass``."""
    lib = build([source])[source]
    sass = subprocess.run([_tool('cuobjdump'), '-sass', str(lib)], capture_output=True,
                          text=True, check=True).stdout
    parts = _SASS_FUNCTION.split(sass)
    return {name: set(_TENSOR_OP.findall(body)) for name, body in zip(parts[1::2], parts[2::2])}


def load(source: str) -> ctypes.CDLL:
    """The library built from ``csrc/<source>``, building it at first use."""
    if source not in _loaded:
        _loaded[source] = ctypes.CDLL(str(build([source])[source]))
    return _loaded[source]

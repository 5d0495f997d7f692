"""Generate the port's per-module API reference into a directory.

The counterpart of the JAX package's ``scripts/gen_api_docs.py`` for
``multigrid_tpu_torch``: one markdown page per public module, generated from
live introspection so signatures never drift from the code, and an index
(``README.md``). Importing the modules needs no card and no compiler.

    python -m multigrid_tpu_torch.gen_api_docs OUT_DIR [--check]

``--check`` exits non-zero if the pages in ``OUT_DIR`` are stale. The JAX
package's ``docs/api/`` is not this script's to write: it refuses it.
"""

from __future__ import annotations

import argparse
import importlib
import inspect
import re
import sys
from pathlib import Path

#: The JAX package's committed pages, which this script never writes.
JAX_DOCS = Path(__file__).resolve().parent.parent / 'docs' / 'api'

#: Packages and modules to document (the public surface).
MODULES = [
    'multigrid_tpu_torch',
    'multigrid_tpu_torch.core',
    'multigrid_tpu_torch.core.actions',
    'multigrid_tpu_torch.core.constants',
    'multigrid_tpu_torch.core.config',
    'multigrid_tpu_torch.core.mission',
    'multigrid_tpu_torch.core.state',
    'multigrid_tpu_torch.envs',
    'multigrid_tpu_torch.envs.env',
    'multigrid_tpu_torch.envs.layout',
    'multigrid_tpu_torch.envs.parity',
    'multigrid_tpu_torch.envs.roomgrid',
    'multigrid_tpu_torch.ops.step',
    'multigrid_tpu_torch.ops.obs',
    'multigrid_tpu_torch.ops.obs_cuda',
    'multigrid_tpu_torch.ops.fused_linear',
    'multigrid_tpu_torch.ops.fused_ppo',
    'multigrid_tpu_torch.ops.fused_policy',
    'multigrid_tpu_torch.parallel.vector',
    'multigrid_tpu_torch.parallel.mesh',
    'multigrid_tpu_torch.parallel.distributed',
    'multigrid_tpu_torch.parallel.dryrun',
    'multigrid_tpu_torch.learn.nets',
    'multigrid_tpu_torch.learn.ppo',
    'multigrid_tpu_torch.wrappers',
    'multigrid_tpu_torch.adapters.gym',
    'multigrid_tpu_torch.adapters.pettingzoo',
    'multigrid_tpu_torch.adapters.rllib',
    'multigrid_tpu_torch.render',
    'multigrid_tpu_torch.train',
    'multigrid_tpu_torch.evaluate',
    'multigrid_tpu_torch.visualize',
    'multigrid_tpu_torch.probe_random_success',
    'multigrid_tpu_torch.utils.build',
    'multigrid_tpu_torch.utils.checkpoint',
    'multigrid_tpu_torch.utils.device',
    'multigrid_tpu_torch.utils.enum',
    'multigrid_tpu_torch.utils.minigrid_interface',
    'multigrid_tpu_torch.utils.minigrid_builder',
    'multigrid_tpu_torch.utils.misc',
    'multigrid_tpu_torch.utils.profiling',
    'multigrid_tpu_torch.utils.rendering',
]

_ADDR = re.compile(r' at 0x[0-9a-f]+')


def _sig(obj) -> str:
    try:
        return _ADDR.sub('', str(inspect.signature(obj)))
    except (ValueError, TypeError):
        return '(...)'


def _doc(obj) -> str:
    d = inspect.getdoc(obj)
    return d.strip() if d else ''


def _public_members(mod):
    """Names defined (or re-exported through ``__all__``) by this module."""
    if hasattr(mod, '__all__'):
        names = list(mod.__all__)
    else:
        names = [n for n, v in vars(mod).items()
                 if not n.startswith('_') and getattr(v, '__module__', None) == mod.__name__]
    return [(n, v) for n in names
            if (v := getattr(mod, n, None)) is not None and callable(v)]


def _render_class(name: str, cls) -> list[str]:
    lines = [f'### class `{name}{_sig(cls)}`', '']
    if _doc(cls):
        lines += [_doc(cls), '']
    bases = [b.__name__ for b in cls.__bases__ if b is not object]
    if bases:
        lines += [f'*Bases:* {", ".join(f"`{b}`" for b in bases)}', '']
    fields = getattr(cls, '__dataclass_fields__', None)
    if fields:
        lines += ['| field | default |', '|---|---|']
        for fn, f in fields.items():
            default = ('' if type(f.default).__name__ == '_MISSING_TYPE'
                       or ' at 0x' in repr(f.default) else f'`{f.default!r}`')
            lines.append(f'| `{fn}` | {default} |')
        lines.append('')
    for mn, mv in sorted(vars(cls).items()):
        if mn.startswith('_') and mn != '__call__':
            continue
        if isinstance(mv, (staticmethod, classmethod)):
            mv = mv.__func__
        if inspect.isfunction(mv):
            lines += [f'#### `{name}.{mn}{_sig(mv)}`', '']
            if _doc(mv):
                lines += [_doc(mv), '']
        elif isinstance(mv, property):
            lines += [f'#### property `{name}.{mn}`', '']
            if _doc(mv):
                lines += [_doc(mv), '']
    return lines


def render_module(modname: str) -> str:
    """One module's page."""
    mod = importlib.import_module(modname)
    lines = [f'# `{modname}`', '']
    if _doc(mod):
        lines += [_doc(mod), '']
    members = _public_members(mod)
    classes = [(n, v) for n, v in members if inspect.isclass(v)]
    functions = [(n, v) for n, v in members if inspect.isfunction(v)]
    if classes:
        lines += ['## Classes', '']
        for n, v in classes:
            lines += _render_class(n, v)
    if functions:
        lines += ['## Functions', '']
        for n, v in functions:
            lines += [f'### `{n}{_sig(v)}`', '']
            if _doc(v):
                lines += [_doc(v), '']
    return '\n'.join(lines).rstrip() + '\n'


def pages() -> dict[str, str]:
    """``{file name: text}`` of every page and the index."""
    out = {m.replace('.', '_') + '.md': render_module(m) for m in MODULES}
    index = ['# multigrid_tpu_torch API reference', '',
             'Generated by `python -m multigrid_tpu_torch.gen_api_docs`: do not edit by hand.',
             '']
    for m in MODULES:
        first = (_doc(importlib.import_module(m)).splitlines() or [''])[0]
        index.append(f'- [`{m}`]({m.replace(".", "_")}.md) — {first}')
    out['README.md'] = '\n'.join(index) + '\n'
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Generate the port's API reference.")
    ap.add_argument('out', type=Path, help='directory to write the pages to')
    ap.add_argument('--check', action='store_true',
                    help='verify that the pages in the directory are current')
    args = ap.parse_args(argv)
    out = args.out.resolve()
    if out == JAX_DOCS:
        ap.error(f'{out} holds the JAX package\'s pages; name another directory')
    generated = pages()
    if args.check:
        stale = [fn for fn, text in generated.items()
                 if not (out / fn).exists() or (out / fn).read_text() != text]
        if stale:
            print(f'stale API docs in {out} (run python -m multigrid_tpu_torch.gen_api_docs '
                  f'{args.out}): {stale}')
            return 1
        print(f'{len(generated)} API pages current')
        return 0
    out.mkdir(parents=True, exist_ok=True)
    for fn, text in generated.items():
        (out / fn).write_text(text)
    print(f'wrote {len(generated)} pages to {out}')
    return 0


if __name__ == '__main__':
    sys.exit(main())

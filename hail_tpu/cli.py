"""`hailctl`-equivalent CLI (reference `hailtop/hailctl/`):

    python -m hail_tpu config set/get/unset/list
    python -m hail_tpu describe <path>          # native table / matrixtable
    python -m hail_tpu batch submit <script>
    python -m hail_tpu version
    python -m hail_tpu devices

The dataproc/hdinsight cluster-management subcommands of the reference manage
Spark clusters and have no analogue here; `devices` reports the jax platform.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _cmd_config(args) -> int:
    from . import config as cfg
    if args.action == 'set':
        cfg.set_config_option(args.key, args.value)
    elif args.action == 'get':
        v = cfg.get_config_option(args.key)
        if v is not None:
            print(v)
    elif args.action == 'unset':
        cfg.unset_config_option(args.key)
    elif args.action == 'list':
        for section, opts in cfg.list_config().items():
            for k, v in opts.items():
                print(f'{section}/{k}={v}')
    elif args.action == 'config-location':
        print(cfg.config_path())
    return 0


def _cmd_describe(args) -> int:
    path = args.path
    meta_path = os.path.join(path, 'metadata.json')
    if not os.path.exists(meta_path):
        print(f'error: no metadata.json under {path}', file=sys.stderr)
        return 1
    with open(meta_path) as f:
        meta = json.load(f)
    kind = meta.get('kind', 'unknown')
    print(f'kind: {kind}')
    if kind == 'table':
        print(f'rows: {sum(p["length"] for p in meta["partitions"])}')
        print(f'partitions: {meta["n_partitions"]}')
        print(f'key: {meta["key"]}')
        print(f'row type: {meta["row_type"]}')
        print(f'globals type: {meta["globals_type"]}')
    elif kind == 'matrix_table':
        print(f'rows: {sum(p["n_rows"] for p in meta["partitions"])}')
        print(f'cols: {meta["n_cols"]}')
        print(f'partitions: {meta["n_partitions"]}')
        print(f'row key: {meta["row_key"]}  col key: {meta["col_key"]}')
        print(f'row type: {meta["row_type"]}')
        print(f'col type: {meta["col_type"]}')
        print(f'entry type: {meta["entry_type"]}')
    elif kind == 'block_matrix' or 'shape' in meta:
        print(f'shape: {meta.get("shape")}')
        print(f'block size: {meta.get("block_size")}')
    return 0


def _cmd_batch(args) -> int:
    if args.action == 'submit':
        script = args.script
        g = {'__name__': '__main__'}
        sys.argv = [script] + (args.script_args or [])
        with open(script) as f:
            code = f.read()
        exec(compile(code, script, 'exec'), g)
        return 0
    print(f'unknown batch action {args.action}', file=sys.stderr)
    return 1


def _cmd_fs(args) -> int:
    from . import fs as hfs
    if args.action == 'ls':
        for e in hfs.ls(args.paths[0]):
            kind = 'd' if e.is_dir else 'f'
            print(f'{kind} {e.size:>12} {e.path}')
    elif args.action == 'cp':
        from .fs.aio import copy_sync
        *srcs, dest = args.paths
        copy_sync([(s_, dest if len(srcs) == 1 else
                    os.path.join(dest, os.path.basename(s_))) for s_ in srcs])
    elif args.action == 'rm':
        from .fs.aio import delete_sync
        delete_sync(args.paths)
    elif args.action == 'stat':
        e = hfs.stat(args.paths[0])
        print(f'path: {e.path}\nsize: {e.size}\ntype: {e.typ}')
    elif args.action == 'mkdir':
        hfs.mkdir(args.paths[0])
    return 0


def _cmd_auth(args) -> int:
    """`hailctl auth login/logout/user/copy-paste-login` against a local
    AuthService (reference hailctl/auth/cli.py, minus the OAuth browser
    flow)."""
    from .services import auth_client
    url = args.url
    if args.action == 'login':
        auth_client.login(url, args.username)
        print(f'logged in as {args.username}')
    elif args.action == 'logout':
        auth_client.logout(url)
        print('logged out')
    elif args.action == 'user':
        import json as _json
        print(_json.dumps(auth_client.get_userinfo(url), indent=2))
    elif args.action == 'copy-paste-login':
        auth_client.copy_paste_login(url, args.username)
        print('logged in')
    return 0


def _cmd_version(args) -> int:
    from . import __version__
    print(__version__)
    return 0


def _cmd_devices(args) -> int:
    import jax
    print(f'backend: {jax.default_backend()}')
    for d in jax.devices():
        print(f'  {d}')
    return 0


def _cmd_docs(args) -> int:
    if args.action == 'build':
        import runpy
        import os as _os
        tool = _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), 'tools', 'gen_api_docs.py')
        runpy.run_path(tool, run_name='__main__')
        return 0
    from .services.docs_site import serve
    serve(port=args.port)
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog='hailctl-tpu', description=__doc__)
    sub = p.add_subparsers(dest='cmd', required=True)

    pc = sub.add_parser('config')
    pc.add_argument('action', choices=['set', 'get', 'unset', 'list', 'config-location'])
    pc.add_argument('key', nargs='?')
    pc.add_argument('value', nargs='?')
    pc.set_defaults(fn=_cmd_config)

    pd = sub.add_parser('describe')
    pd.add_argument('path')
    pd.set_defaults(fn=_cmd_describe)

    pb = sub.add_parser('batch')
    pb.add_argument('action', choices=['submit'])
    pb.add_argument('script')
    pb.add_argument('script_args', nargs='*')
    pb.set_defaults(fn=_cmd_batch)

    pf = sub.add_parser('fs')
    pf.add_argument('action', choices=['ls', 'cp', 'rm', 'stat', 'mkdir'])
    pf.add_argument('paths', nargs='+')
    pf.set_defaults(fn=_cmd_fs)

    pa = sub.add_parser('auth')
    pa.add_argument('action', choices=['login', 'logout', 'user',
                                       'copy-paste-login'])
    pa.add_argument('username', nargs='?',
                    help='username (login) or token (copy-paste-login)')
    pa.add_argument('--url', default='http://127.0.0.1:5000')
    pa.set_defaults(fn=_cmd_auth)

    pv = sub.add_parser('version')
    pv.set_defaults(fn=_cmd_version)

    pdev = sub.add_parser('devices')
    pdev.set_defaults(fn=_cmd_devices)

    pdoc = sub.add_parser('docs', help='build or serve the documentation '
                                       'site (user guide + API reference)')
    pdoc.add_argument('action', choices=['build', 'serve'])
    pdoc.add_argument('--port', type=int, default=8080)
    pdoc.set_defaults(fn=_cmd_docs)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == '__main__':
    raise SystemExit(main())

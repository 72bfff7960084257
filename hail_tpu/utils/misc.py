"""General utility helpers (reference hail/utils/misc.py + java.py +
deduplicate.py + tutorial.py)."""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np

from .structs import Struct


class HailUserError(Exception):
    """An error caused by invalid user input (reference utils/java.py:16)."""


class FatalError(Exception):
    """An unrecoverable engine error (reference utils/java.py:20)."""


def error(msg: str) -> None:
    """Log an error-level message (reference utils/java.py error)."""
    print(f'ERROR: {msg}')


def warning(msg: str) -> None:
    print(f'WARNING: {msg}')


def info(msg: str) -> None:
    print(msg)


def default_handler():
    """The default display handler for show()-style output."""
    return print


def wrap_to_list(x):
    return x if isinstance(x, list) else [x]


def get_env_or_default(maybe_value, env_var: str, default):
    import os as _os
    return maybe_value if maybe_value is not None else _os.environ.get(env_var, default)


def uri_path(uri: str) -> str:
    if uri.startswith('file://'):
        return uri[7:]
    return uri


def local_path_uri(path: str) -> str:
    return 'file://' + os.path.abspath(path)


def new_temp_file(prefix: Optional[str] = None, extension: Optional[str] = None) -> str:
    """Fresh path in the session temporary directory (reference
    utils/misc.py:178)."""
    from ..context import Env
    tmpdir = Env.hc().tmp_dir if Env.is_initialized() else tempfile.gettempdir()
    import uuid
    name = uuid.uuid4().hex
    if prefix:
        name = f'{prefix}-{name}'
    if extension:
        name = f'{name}.{extension}'
    os.makedirs(tmpdir, exist_ok=True)
    return os.path.join(tmpdir, name)


def new_local_temp_dir(suffix=None, prefix=None, dir=None) -> str:
    return tempfile.mkdtemp(suffix, prefix, dir)


def new_local_temp_file(filename: str = 'temp') -> str:
    d = new_local_temp_dir()
    return os.path.join(d, filename)


class with_local_temp_file:
    """Context manager yielding a local temp file path, removed on exit."""

    def __init__(self, filename: str = 'temp'):
        self.filename = filename

    def __enter__(self) -> str:
        self.path = new_local_temp_file(self.filename)
        return self.path

    def __exit__(self, *exc):
        try:
            if os.path.exists(self.path):
                os.remove(self.path)
        except OSError:
            pass


def run_command(args: List[str]) -> str:
    return subprocess.check_output(args, stderr=subprocess.STDOUT).decode()


def timestamp_path(base: str, suffix: str = '') -> str:
    ts = time.strftime('%Y%m%d-%H%M')
    return f'{base}-{ts}{suffix}'


def guess_cloud_spark_provider() -> Optional[str]:
    """No managed Spark providers exist in this environment."""
    return None


def chunk(size: int, seq: Sequence):
    for i in range(0, len(seq), size):
        yield seq[i:i + size]


def maybe(f: Callable, ma, default=None):
    return f(ma) if ma is not None else default


def no_service_backend(unsupported_feature: str):
    """Raise when a feature is unsupported on the service backend; this build
    has no service backend so it is a no-op guard."""
    return None


def storage_level(level: str = 'MEMORY_AND_DISK') -> str:
    """Spark storage levels have no analogue here; persisted tables live in
    host memory."""
    return level


def deduplicate(ids: Sequence[str], max_attempts: Optional[int] = None,
                already_used: Optional[set] = None) -> Tuple[List[Tuple[str, str]], List[str]]:
    """Append _N suffixes to duplicate identifiers (reference
    utils/deduplicate.py). Returns (renames, new_ids)."""
    used = set(already_used) if already_used is not None else set()
    renames: List[Tuple[str, str]] = []
    out: List[str] = []
    for s in ids:
        if s not in used:
            used.add(s)
            out.append(s)
            continue
        i = 1
        while True:
            cand = f'{s}_{i}'
            if cand not in used:
                break
            i += 1
            if max_attempts is not None and i > max_attempts:
                raise RecursionError(
                    f'cannot deduplicate {s} after {max_attempts} attempts')
        used.add(cand)
        renames.append((s, cand))
        out.append(cand)
    return renames, out


class LinkedList:
    """Immutable singly-linked list (reference utils/linkedlist.py)."""

    class Node:
        __slots__ = ('value', 'next')

        def __init__(self, value, next_node):
            self.value = value
            self.next = next_node

    def __init__(self, type_):
        self.type = type_
        self.node = None
        self.count = 0

    def push(self, *xs) -> 'LinkedList':
        out = self
        for x in xs:
            new = LinkedList(out.type)
            new.node = LinkedList.Node(x, out.node)
            new.count = out.count + 1
            out = new
        return out

    def empty(self) -> bool:
        return self.node is None

    def __len__(self):
        return self.count

    def __iter__(self):
        n = self.node
        while n is not None:
            yield n.value
            n = n.next

    def __str__(self):
        return 'List(' + ', '.join(str(x) for x in self) + ')'

    def __repr__(self):
        return str(self)

    def __eq__(self, other):
        return isinstance(other, LinkedList) and list(self) == list(other)


class JSONEncoder(json.JSONEncoder):
    """JSON encoder aware of hail values (Struct, Locus, Call, intervals,
    frozendict) — reference utils/misc.py JSONEncoder."""

    def default(self, o: Any) -> Any:
        from .structs import Struct, frozendict, Interval
        from ..genetics.locus import Locus
        from ..genetics.call import Call
        if isinstance(o, Struct):
            return dict(o)
        if isinstance(o, frozendict):
            return dict(o)
        if isinstance(o, Interval):
            return {'start': o.start, 'end': o.end,
                    'includes_start': o.includes_start,
                    'includes_end': o.includes_end}
        if isinstance(o, Locus):
            return {'contig': o.contig, 'position': o.position,
                    'reference_genome': str(o.reference_genome)}
        if isinstance(o, Call):
            return str(o)
        if isinstance(o, (set, frozenset)):
            return sorted(o) if all(isinstance(x, (int, float, str)) for x in o) else list(o)
        import numpy as np
        if isinstance(o, np.generic):
            return o.item()
        if isinstance(o, np.ndarray):
            return o.tolist()
        return super().default(o)


def _dumps_partitions(partitions, row_key_type):
    """Serialize interval partition bounds as JSON (reference misc.py)."""
    return json.dumps([
        {'start': p.start, 'end': p.end,
         'includeStart': p.includes_start, 'includeEnd': p.includes_end}
        for p in partitions
    ], cls=JSONEncoder)


# -- tutorial datasets (reference utils/tutorial.py) ------------------------
# The reference downloads public subsets (1KG ~15MB, HGDP ~30MB,
# MovieLens-100k). This build has no egress, so these synthesize a
# deterministic dataset with the same file layout, schemas, and annotation
# columns — every tutorial pipeline (GWAS, PCA, MovieLens joins) runs
# unmodified against them.

_1KG_POPS = [('GBR', 'EUR'), ('FIN', 'EUR'), ('CHS', 'EAS'), ('PUR', 'AMR'),
             ('CDX', 'EAS'), ('CLM', 'AMR'), ('IBS', 'EUR'), ('PEL', 'AMR'),
             ('PJL', 'SAS'), ('KHV', 'EAS'), ('ACB', 'AFR'), ('GWD', 'AFR'),
             ('ESN', 'AFR'), ('BEB', 'SAS'), ('MSL', 'AFR'), ('STU', 'SAS'),
             ('ITU', 'SAS'), ('CEU', 'EUR'), ('YRI', 'AFR'), ('CHB', 'EAS'),
             ('JPT', 'EAS'), ('LWK', 'AFR'), ('ASW', 'AFR'), ('MXL', 'AMR'),
             ('TSI', 'EUR'), ('GIH', 'SAS')]


def _synth_vcf(path: str, samples, contigs, n_variants: int, seed: int,
               chr_prefix: bool = False) -> None:
    """Deterministic multi-sample VCF with GT:AD:DP:GQ entries, gzip-written
    (readable by import_vcf's .bgz path)."""
    import gzip as _gzip
    rng = np.random.default_rng(seed)
    n = len(samples)
    alleles = ['A', 'C', 'G', 'T']
    with _gzip.open(path, 'wt') as f:
        f.write('##fileformat=VCFv4.2\n##source=hail_tpu_tutorial\n')
        f.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
        f.write('##FORMAT=<ID=AD,Number=.,Type=Integer,Description="Allelic depth">\n')
        f.write('##FORMAT=<ID=DP,Number=1,Type=Integer,Description="Read depth">\n')
        f.write('##FORMAT=<ID=GQ,Number=1,Type=Integer,Description="Genotype quality">\n')
        f.write('##INFO=<ID=AC,Number=A,Type=Integer,Description="Allele count">\n')
        f.write('#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t'
                + '\t'.join(samples) + '\n')
        per_contig = n_variants // len(contigs)
        for ci, contig in enumerate(contigs):
            m = per_contig if ci < len(contigs) - 1 else \
                n_variants - per_contig * (len(contigs) - 1)
            pos = np.sort(rng.choice(
                np.arange(10_000, 5_000_000, dtype=np.int64), m, replace=False))
            af = rng.beta(0.8, 0.8, size=m).clip(0.02, 0.98)
            for vi in range(m):
                ref, alt = rng.choice(4, 2, replace=False)
                nalt = rng.binomial(2, af[vi], size=n)
                dp = rng.integers(10, 60, size=n)
                name = f'chr{contig}' if chr_prefix else str(contig)
                row = [name, str(pos[vi]), '.', alleles[ref], alleles[alt],
                       '100', 'PASS', f'AC={int(nalt.sum())}', 'GT:AD:DP:GQ']
                for s in range(n):
                    g = nalt[s]
                    gt = ('0/0', '0/1', '1/1')[g]
                    ad_alt = (0, dp[s] // 2, dp[s])[g]
                    row.append(f'{gt}:{dp[s] - ad_alt},{ad_alt}:{dp[s]}:'
                               f'{int(rng.integers(20, 99))}')
                f.write('\t'.join(row) + '\n')


def _write_gene_annotations(path: str, contigs, seed: int) -> None:
    rng = np.random.default_rng(seed)
    with open(path, 'w') as f:
        f.write('Gene stable ID\tGene name\tChromosome/scaffold name\t'
                'Gene start (bp)\tGene end (bp)\tGene type\n')
        gid = 1000
        for contig in contigs:
            for i in range(8):
                start = int(rng.integers(10_000, 4_500_000))
                f.write(f'ENSG{gid:011d}\tGENE{gid}\t{contig}\t{start}\t'
                        f'{start + int(rng.integers(1000, 400_000))}\t'
                        f'protein_coding\n')
                gid += 1


def get_1kg(output_dir: str, overwrite: bool = False) -> None:
    """Materialize the 1000-genomes tutorial dataset layout (reference
    utils/tutorial.py:47-103: 1kg.mt, 1kg.vcf.bgz, 1kg_annotations.txt,
    ensembl_gene_annotations.txt). The reference downloads the real ~15MB
    subset; this synthesizes a deterministic stand-in with the same schemas."""
    import hail_tpu as hl
    os.makedirs(output_dir, exist_ok=True)
    mt_path = os.path.join(output_dir, '1kg.mt')
    vcf_path = os.path.join(output_dir, '1kg.vcf.bgz')
    annot_path = os.path.join(output_dir, '1kg_annotations.txt')
    gene_path = os.path.join(output_dir, 'ensembl_gene_annotations.txt')
    if not overwrite and all(os.path.exists(p) for p in
                             (mt_path, vcf_path, annot_path, gene_path)):
        return
    rng = np.random.default_rng(1000)
    samples = [f'HG{i:05d}' for i in range(96, 96 + 250)]
    contigs = ['1', '2', '3', '4', '20', 'X']
    _synth_vcf(vcf_path, samples, contigs, 1200, seed=1001)
    hl.import_vcf(vcf_path, min_partitions=4).write(mt_path, overwrite=True)
    with open(annot_path, 'w') as f:
        f.write('\t'.join(['Sample', 'Population', 'SuperPopulation', 'isFemale',
                           'PurpleHair', 'CaffeineConsumption']) + '\n')
        for s in samples:
            pop, superpop = _1KG_POPS[int(rng.integers(len(_1KG_POPS)))]
            f.write(f'{s}\t{pop}\t{superpop}\t'
                    f'{str(bool(rng.integers(2))).lower()}\t'
                    f'{str(bool(rng.integers(2))).lower()}\t'
                    f'{int(rng.integers(0, 10))}\n')
    _write_gene_annotations(gene_path, contigs[:-1], seed=1002)


def get_hgdp(output_dir: str, overwrite: bool = False) -> None:
    """Materialize the HGDP tutorial dataset layout (reference
    utils/tutorial.py:106-165, GRCh38): HGDP.mt, HGDP.vcf.bgz,
    HGDP_annotations.txt, ensembl_gene_annotations.txt. Synthesized
    deterministically (no egress)."""
    import hail_tpu as hl
    os.makedirs(output_dir, exist_ok=True)
    mt_path = os.path.join(output_dir, 'HGDP.mt')
    vcf_path = os.path.join(output_dir, 'HGDP.vcf.bgz')
    annot_path = os.path.join(output_dir, 'HGDP_annotations.txt')
    gene_path = os.path.join(output_dir, 'ensembl_gene_annotations.txt')
    if not overwrite and all(os.path.exists(p) for p in
                             (mt_path, vcf_path, annot_path, gene_path)):
        return
    rng = np.random.default_rng(2000)
    samples = [f'HGDP{i:05d}' for i in range(1, 61)]
    contigs = ['1', '2', '21']
    _synth_vcf(vcf_path, samples, contigs, 900, seed=2001, chr_prefix=True)
    hl.import_vcf(vcf_path, min_partitions=4,
                  reference_genome='GRCh38').write(mt_path, overwrite=True)
    regions = ['AFRICA', 'EUROPE', 'EAST_ASIA', 'AMERICA', 'OCEANIA',
               'CENTRAL_SOUTH_ASIA', 'MIDDLE_EAST']
    with open(annot_path, 'w') as f:
        f.write('sample_id\tregion\tpopulation\tsex\n')
        for s in samples:
            region = regions[int(rng.integers(len(regions)))]
            f.write(f'{s}\t{region}\tPOP{int(rng.integers(1, 10))}\t'
                    f'{"XX" if rng.integers(2) else "XY"}\n')
    _write_gene_annotations(gene_path, [f'chr{c}' for c in contigs], seed=2002)


def get_movie_lens(output_dir: str, overwrite: bool = False) -> None:
    """Materialize the MovieLens tutorial tables (reference
    utils/tutorial.py:168-260: movies.ht, ratings.ht, users.ht with the
    MovieLens-100k schemas). Synthesized deterministically (no egress)."""
    import hail_tpu as hl
    os.makedirs(output_dir, exist_ok=True)
    movies_path = os.path.join(output_dir, 'movies.ht')
    ratings_path = os.path.join(output_dir, 'ratings.ht')
    users_path = os.path.join(output_dir, 'users.ht')
    if not overwrite and all(os.path.exists(p) for p in
                             (movies_path, ratings_path, users_path)):
        return
    rng = np.random.default_rng(3000)
    genres = ['Action', 'Adventure', 'Animation', "Children's", 'Comedy',
              'Crime', 'Documentary', 'Drama', 'Fantasy', 'Film-Noir',
              'Horror', 'Musical', 'Mystery', 'Romance', 'Sci-Fi',
              'Thriller', 'War', 'Western']
    occupations = ['administrator', 'artist', 'doctor', 'educator',
                   'engineer', 'entertainment', 'executive', 'healthcare',
                   'lawyer', 'librarian', 'marketing', 'none', 'other',
                   'programmer', 'retired', 'salesman', 'scientist',
                   'student', 'technician', 'writer']
    n_users, n_movies, n_ratings = 200, 300, 5000
    users = [Struct(id=i + 1, age=int(rng.integers(18, 73)),
                    sex='F' if rng.integers(2) else 'M',
                    occupation=occupations[int(rng.integers(len(occupations)))],
                    zipcode=f'{int(rng.integers(10000, 99999))}')
             for i in range(n_users)]
    movies = [Struct(movie_id=i + 1, title=f'Movie {i + 1} ({1970 + int(rng.integers(50))})',
                     genres=sorted(rng.choice(genres,
                                              int(rng.integers(1, 4)),
                                              replace=False).tolist()))
              for i in range(n_movies)]
    ratings = [Struct(user_id=int(rng.integers(1, n_users + 1)),
                      movie_id=int(rng.integers(1, n_movies + 1)),
                      rating=int(rng.integers(1, 6)))
               for _ in range(n_ratings)]
    hl.Table.parallelize(
        users, hl.tstruct(id=hl.tint32, age=hl.tint32, sex=hl.tstr,
                          occupation=hl.tstr, zipcode=hl.tstr),
        key='id').write(users_path, overwrite=True)
    hl.Table.parallelize(
        movies, hl.tstruct(movie_id=hl.tint32, title=hl.tstr,
                           genres=hl.tarray(hl.tstr)),
        key='movie_id').write(movies_path, overwrite=True)
    hl.Table.parallelize(
        ratings, hl.tstruct(user_id=hl.tint32, movie_id=hl.tint32,
                            rating=hl.tint32)).write(ratings_path,
                                                     overwrite=True)


_CONTROL_ESCAPES = {'\b': '\\b', '\n': '\\n', '\t': '\\t', '\f': '\\f',
                    '\r': '\\r'}


def escape_str(s: str, backticked: bool = False) -> str:
    """Escape a string to Hail text form (reference `utils/misc.py:568`):
    non-ASCII and control chars become \\uXXXX, quotes/backticks escape
    per context."""
    out = []
    for ch in s:
        n = ord(ch)
        if n > 0x7F:
            out.append(f'\\u{n:04X}')
        elif n < 32:
            esc = _CONTROL_ESCAPES.get(ch)
            out.append(esc if esc is not None else f'\\u{n:04X}')
        elif ch == '"':
            out.append('"' if backticked else '\\"')
        elif ch == '`':
            out.append('\\`' if backticked else '`')
        elif ch == '\\':
            out.append('\\\\')
        else:
            out.append(ch)
    return ''.join(out)


def escape_id(s: str) -> str:
    """Backtick-quote an identifier unless it is a plain word
    (reference `utils/misc.py:605`)."""
    import re
    if re.fullmatch(r'[_a-zA-Z]\w*', s):
        return s
    return f'`{escape_str(s, backticked=True)}`'


import threading as _threading

_thread_loops = _threading.local()


def hail_event_loop():
    """This thread's persistent event loop, created on first use (reference
    `hailtop.hail_event_loop`). Loop-bound resources (aiohttp sessions) stay
    valid across successive async_to_blocking calls."""
    import asyncio
    loop = getattr(_thread_loops, 'loop', None)
    if loop is None or loop.is_closed():
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        _thread_loops.loop = loop
    return loop


def async_to_blocking(coro):
    """Run a coroutine to completion on this thread's persistent loop
    (reference `hailtop/utils/utils.py` async_to_blocking)."""
    import asyncio
    try:
        running = asyncio.get_running_loop()
    except RuntimeError:
        running = None
    if running is not None:
        raise RuntimeError('async_to_blocking called from a running event loop')
    return hail_event_loop().run_until_complete(coro)


def secret_alnum_string(n: int = 22, *, case: str = 'mixed') -> str:
    """Random alphanumeric token (reference hailtop/utils secret_alnum_string)."""
    import secrets
    import string
    if case == 'lowercase':
        alphabet = string.ascii_lowercase + string.digits
    elif case == 'uppercase':
        alphabet = string.ascii_uppercase + string.digits
    elif case == 'numbers':
        alphabet = string.digits
    else:
        alphabet = string.ascii_letters + string.digits
    return ''.join(secrets.choice(alphabet) for _ in range(n))


def sync_check_exec(*argv, capture_output: bool = False, env=None):
    """Run a subprocess, raising on nonzero exit (reference
    `hailtop/utils/process.py` sync_check_exec)."""
    import subprocess
    return subprocess.run(list(argv), check=True, capture_output=capture_output,
                          env=env)

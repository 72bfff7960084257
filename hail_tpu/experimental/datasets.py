"""Annotation datasets: `hl.experimental.load_dataset` and the Annotation DB.

Reference surface: `hail/python/hail/experimental/datasets.py` (load_dataset),
`db.py` (DatasetVersion / Dataset / DB), `datasets_metadata.py`, `lens.py`.

Zero-egress by default.  The registry is resolved in
order:

1. an explicit ``config=`` dict or ``url=`` path handed to :class:`DB`,
2. the path named by the ``HAIL_TPU_DATASETS_CONFIG`` environment variable
   (any local/fsspec path to a registry JSON; lets an offline site mirror
   the datasets and point the framework at its own copies),
3. the bundled registry ``hail_tpu/resources/datasets.json`` — the canonical
   public dataset names with their well-known cloud bucket layouts (loading
   those requires cloud FS credentials, exactly as in the reference).

Registry JSON shape (same as the reference's ``datasets.json``)::

    {"<name>": {"description": ..., "url": ...,
                "annotation_db": {"key_properties": ["unique"|"gene", ...]},
                "versions": [{"version": ..., "reference_genome": ...,
                              "url": {"gcp": {"us-central1": "..."},
                                      "aws": {"us": "..."}}}]}}

A version ``url`` may also be a plain string (local path) — that extension
is what makes offline registries work: ``{"url": "/data/cadd.ht"}``.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Set, Union

from .. import types as ht

_BUNDLED = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        'resources', 'datasets.json')

_VALID_REGIONS = {'us', 'us-central1', 'europe-west1'}
_VALID_CLOUDS = {'gcp', 'aws'}
_VALID_COMBINATIONS = {('us', 'aws'), ('us-central1', 'gcp'), ('europe-west1', 'gcp')}


def get_datasets_metadata(path: Optional[str] = None) -> dict:
    """Load the datasets registry (reference `datasets_metadata.py`).

    ``path`` overrides; else ``HAIL_TPU_DATASETS_CONFIG``; else the bundled
    registry."""
    path = path or os.environ.get('HAIL_TPU_DATASETS_CONFIG') or _BUNDLED
    if '://' in path and not path.startswith('file://'):
        from ..fs import open as fs_open
        with fs_open(path, 'r') as fp:
            return json.load(fp)
    if path.startswith('file://'):
        path = path[len('file://'):]
    with open(path, 'r') as fp:
        return json.load(fp)


def _read_dataset(path: str):
    import hail_tpu as hl
    if path.endswith('.ht'):
        return hl.read_table(path)
    elif path.endswith('.mt'):
        return hl.read_matrix_table(path)
    elif path.endswith('.bm'):
        return hl.linalg.BlockMatrix.read(path)
    raise ValueError(f'Invalid path: {path}. Can only load datasets with '
                     f'.ht, .mt, or .bm extensions.')


def _version_path(doc: dict, region: str, cloud: str) -> Optional[str]:
    """Resolve a version's url doc to a concrete path (str urls pass through)."""
    url = doc['url']
    if isinstance(url, str):
        return url
    if cloud in url and region in url[cloud]:
        return url[cloud][region]
    return None


def load_dataset(name: str, version: Optional[str],
                 reference_genome: Optional[str],
                 region: str = 'us-central1', cloud: str = 'gcp'):
    """Load a named dataset from the registry (reference
    `experimental/datasets.py load_dataset`). Validation error messages keep
    the reference's shape: bad region/cloud/name/version/build each raise a
    ValueError naming the valid choices."""
    if region not in _VALID_REGIONS:
        raise ValueError(f'Specify valid region parameter, received: region={region!r}.\n'
                         f'Valid region values are {_VALID_REGIONS}.')
    if cloud not in _VALID_CLOUDS:
        raise ValueError(f'Specify valid cloud parameter, received: cloud={cloud!r}.\n'
                         f'Valid cloud platforms are {_VALID_CLOUDS}.')
    datasets = get_datasets_metadata()
    if name not in datasets:
        raise ValueError(f'{name} is not a dataset available in the repository.')
    versions = set(d['version'] for d in datasets[name]['versions'])
    if version not in versions:
        raise ValueError(f'Version {version!r} not available for dataset {name!r}.\n'
                         f'Available versions: {versions}.')
    builds = set(d['reference_genome'] for d in datasets[name]['versions'])
    if reference_genome not in builds:
        raise ValueError(f'Reference genome build {reference_genome!r} not available for '
                         f'dataset {name!r}.\nAvailable reference genome builds: {builds}.')
    matches = [d for d in datasets[name]['versions']
               if d['version'] == version and d['reference_genome'] == reference_genome]
    paths = [p for p in (_version_path(d, region, cloud) for d in matches) if p is not None]
    if not paths:
        raise ValueError(f'Dataset {name!r} version {version!r} not available in '
                         f'region {region!r} on cloud {cloud!r}.')
    return _read_dataset(paths[0])


# ---------------------------------------------------------------------------
# Annotation DB (reference db.py)
# ---------------------------------------------------------------------------

class DatasetVersion:
    """One (version, reference_genome) of an annotation dataset
    (reference `db.py DatasetVersion`)."""

    def __init__(self, url: str, version: Optional[str], reference_genome: Optional[str]):
        self.url = url
        self.version = version
        self.reference_genome = reference_genome
        self._table = None

    @staticmethod
    def from_json(doc: dict, region: str, cloud: str) -> Optional['DatasetVersion']:
        assert 'url' in doc and 'version' in doc and 'reference_genome' in doc, doc
        path = _version_path(doc, region, cloud)
        if path is None:
            return None
        return DatasetVersion(path, doc['version'], doc['reference_genome'])

    def _load(self):
        if self._table is None:
            import hail_tpu as hl
            self._table = hl.read_table(self.url)
        return self._table

    def maybe_index(self, indexer_key_expr, all_matches: bool):
        """Index this version's table by `indexer_key_expr` if the key types
        are compatible (reference `Table._maybe_flexindex_table_by_expr`):
        exact key-type match, a prefix match on the leading key field, or an
        interval-keyed table indexed by a point."""
        t = self._load()
        tkey = t._stage.key
        if not tkey:
            return None
        ktypes = [t._stage.row_type[k] for k in tkey]
        if isinstance(indexer_key_expr, (list, tuple)):
            exprs = list(indexer_key_expr)
        else:
            # a StructExpression key (rel.key) or a single expression
            try:
                exprs = [indexer_key_expr[f] for f in indexer_key_expr.dtype.fields]
            except (AttributeError, TypeError):
                exprs = [indexer_key_expr]
        # interval-keyed dataset + point indexer
        if len(ktypes) == 1 and isinstance(ktypes[0], ht.tinterval) \
                and exprs and exprs[0].dtype == ktypes[0].point_type:
            return self._index(t, [exprs[0]], all_matches)
        # exact / prefix key-type match
        if len(exprs) >= len(ktypes) and \
                all(e.dtype == kt for e, kt in zip(exprs, ktypes)):
            return self._index(t, exprs[:len(ktypes)], all_matches)
        if exprs and ktypes and exprs[0].dtype == ktypes[0]:
            return self._index(t, exprs[:1], all_matches)
        return None

    @staticmethod
    def _index(t, exprs, all_matches: bool):
        if not all_matches:
            return t.index(*exprs)
        # all-matches: group the dataset by key collecting row values, then a
        # unique-key join yields the array of all matching rows (reference
        # returns an array annotation for non-unique datasets).
        import hail_tpu as hl
        key = list(t._stage.key)
        if len(exprs) < len(key):
            t = t.key_by(*key[:len(exprs)])
            key = key[:len(exprs)]
        g = t.group_by(*[t[k] for k in key]).aggregate(
            all_matches_=hl.agg.collect(t.row_value))
        return g.index(*exprs)['all_matches_']


class Dataset:
    """A named annotation dataset with its available versions
    (reference `db.py Dataset`)."""

    def __init__(self, name: str, description: str, url: str,
                 key_properties: Set[str], versions: List[DatasetVersion]):
        assert set(key_properties).issubset(DB._valid_key_properties)
        self.name = name
        self.description = description
        self.url = url
        self.key_properties = key_properties
        self.versions = versions

    @staticmethod
    def from_name_and_json(name: str, doc: dict, region: str, cloud: str) -> Optional['Dataset']:
        assert 'annotation_db' in doc and 'versions' in doc, doc
        key_properties = set(doc['annotation_db'].get('key_properties', []))
        versions = [v for v in (DatasetVersion.from_json(x, region, cloud)
                                for x in doc['versions']) if v is not None]
        if not versions:
            return None
        return Dataset(name, doc.get('description', ''), doc.get('url', ''),
                       key_properties, versions)

    @property
    def is_gene_keyed(self) -> bool:
        return 'gene' in self.key_properties

    def index_compatible_version(self, key_expr):
        all_matches = 'unique' not in self.key_properties
        compatible = [(v.maybe_index(key_expr, all_matches), v.version)
                      for v in self.versions
                      if v.maybe_index(key_expr, all_matches) is not None]
        if not compatible:
            versions = [f'{(v.version, v.reference_genome)}' for v in self.versions]
            raise ValueError(
                f'Could not find compatible version of {self.name} for user dataset.\n'
                f'This annotation dataset is available for the following versions and '
                f'reference genome builds: {", ".join(versions)}.')
        return sorted(compatible, key=lambda x: (x[1] is not None, x[1]))[-1][0]


class _TableRows:
    """Row lens over a Table (reference `lens.py TableRows`)."""

    def __init__(self, t):
        self.t = t
        self.key = t.key

    def annotate(self, **kw):
        return _TableRows(self.t.annotate(**kw))

    def drop(self, *fields):
        return _TableRows(self.t.drop(*fields))

    def unlens(self):
        return self.t


class _MatrixRows:
    """Row lens over a MatrixTable (reference `lens.py MatrixRows`)."""

    def __init__(self, mt):
        self.mt = mt
        self.key = mt.row_key

    def annotate(self, **kw):
        return _MatrixRows(self.mt.annotate_rows(**kw))

    def drop(self, *fields):
        return _MatrixRows(self.mt.drop(*fields))

    def unlens(self):
        return self.mt


class DB:
    """An annotation database instance (reference `db.py DB`): joins named
    annotation datasets onto the rows of a Table/MatrixTable by key-type
    compatibility. Datasets whose registry entry has an ``annotation_db``
    stanza are eligible; ``key_properties`` of ``unique`` yields a struct
    annotation, otherwise an array of all matches; ``gene`` joins through
    the ``gencode`` gene map."""

    _valid_key_properties = {'gene', 'unique'}
    _valid_regions = _VALID_REGIONS
    _valid_clouds = _VALID_CLOUDS
    _valid_combinations = _VALID_COMBINATIONS

    def __init__(self, *, region: str = 'us-central1', cloud: str = 'gcp',
                 url: Optional[str] = None, config: Optional[dict] = None):
        if region not in DB._valid_regions:
            raise ValueError(f'Specify valid region parameter, received: region={region!r}.\n'
                             f'Valid regions are {DB._valid_regions}.')
        if cloud not in DB._valid_clouds:
            raise ValueError(f'Specify valid cloud parameter, received: cloud={cloud!r}.\n'
                             f'Valid cloud platforms are {DB._valid_clouds}.')
        if (region, cloud) not in DB._valid_combinations:
            raise ValueError(f'The {region!r} region is not available for the {cloud!r} '
                             f'cloud platform. Valid region, cloud combinations are '
                             f'{DB._valid_combinations}.')
        if config is not None and url is not None:
            raise ValueError(f'Only specify one of the parameters url and config, '
                             f'received: url={url} and config={config}')
        if config is None:
            config = get_datasets_metadata(url)
        elif not isinstance(config, dict):
            raise ValueError(f'expected a dict mapping dataset names to configurations, '
                             f'but found {config}')
        config = {k: v for k, v in config.items() if 'annotation_db' in v}
        self.region = region
        self.cloud = cloud
        self.url = url
        self.config = config
        self.__by_name = {}
        for k, v in config.items():
            d = Dataset.from_name_and_json(k, v, region, cloud)
            if d is not None:
                self.__by_name[k] = d

    @property
    def available_datasets(self) -> List[str]:
        return sorted(self.__by_name.keys())

    @staticmethod
    def _row_lens(rel):
        from ..matrixtable import MatrixTable
        from ..table import Table
        if isinstance(rel, MatrixTable):
            return _MatrixRows(rel)
        elif isinstance(rel, Table):
            return _TableRows(rel)
        raise ValueError('annotation database can only annotate Hail MatrixTable or Table')

    def _dataset_by_name(self, name: str) -> Dataset:
        if name not in self.__by_name:
            raise ValueError(f'{name} not found in annotation database, you may list all '
                             f'known dataset names with available_datasets')
        return self.__by_name[name]

    def _gene_dict_table(self, rel_rows, dataset: Dataset):
        """Build a table keyed like `rel_rows` mapping each row to a
        dict<gene, annotation> for a gene-keyed dataset, through gencode's
        locus→gene map (reference `db.py DB.annotate_rows_db` gene branch)."""
        import hail_tpu as hl
        gencode = self._dataset_by_name('gencode')
        gidx = gencode.index_compatible_version(rel_rows.key)
        if isinstance(gidx.dtype, ht.tarray):
            genes = gidx.map(lambda s: s.gene_name)
        else:
            genes = hl.array([gidx.gene_name])
        gt = rel_rows.annotate(genes_=genes)
        ex = gt.explode('genes_')
        ex = ex.annotate(ann_=dataset.index_compatible_version([ex.genes_]))
        keyf = list(ex._stage.key)
        g = ex.group_by(*[ex[k] for k in keyf]).aggregate(
            dict_=hl.dict(hl.agg.filter(hl.is_defined(ex.ann_),
                                         hl.agg.collect((ex.genes_, ex.ann_)))))
        return g

    def annotate_rows_db(self, rel, *names: str):
        """Annotate `rel`'s rows with the named datasets (reference
        `db.py DB.annotate_rows_db`). Gene-keyed datasets become a
        dict<gene, annotation>; non-unique datasets an array of matches;
        unique datasets a struct."""
        import hail_tpu as hl
        from ..matrixtable import MatrixTable
        if len(set(names)) != len(names):
            raise ValueError(f'cannot annotate same dataset twice, '
                             f'please remove duplicates from: {names}')
        unavailable = [x for x in names if x not in self.__by_name]
        if unavailable:
            raise ValueError(f'datasets: {unavailable} not available in the '
                             f'{self.region} region.')
        datasets = [self._dataset_by_name(n) for n in names]
        if any(d.is_gene_keyed for d in datasets) and 'gencode' not in self.__by_name:
            raise ValueError('gene-keyed annotation requires the gencode dataset '
                             'in the registry')
        lens = self._row_lens(rel)
        is_mt = isinstance(rel, MatrixTable)
        for dataset in datasets:
            if dataset.is_gene_keyed:
                rows = rel.rows().select() if is_mt else lens.unlens().select()
                g = self._gene_dict_table(rows, dataset)
                lens = lens.annotate(**{dataset.name: g.index(lens.key).dict_})
            else:
                indexed = dataset.index_compatible_version(lens.key)
                if isinstance(indexed.dtype, ht.tstruct) and len(indexed.dtype.fields) == 0:
                    indexed = hl.is_defined(indexed)
                lens = lens.annotate(**{dataset.name: indexed})
        return lens.unlens()

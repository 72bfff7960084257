"""hail_tpu: an accelerator-native data-analysis / genomics engine with the
capabilities of Hail (import as `import hail_tpu as hl`).

See ARCHITECTURE.md for the layer map and SURVEY.md for the reference
inventory this mirrors.
"""

from . import types as _types_mod
from .types import (HailType, dtype, tint, tfloat, tint32, tint64, tfloat32, tfloat64, tbool,
                    tstr, tcall, tvoid, tbinary, tlocus, tarray, tset, tdict,
                    tstruct, ttuple, tinterval, tndarray)
from .utils.structs import Struct, frozendict, Interval
from . import genetics
from .genetics import (AlleleType, Call, Locus, Pedigree, Trio, ReferenceGenome)
from .context import (init, stop, default_reference, get_reference,
                      init_local, init_batch, init_spark, spark_context,
                      version, citation, cite_hail, cite_hail_bibtex,
                      copy_log, debug_info, _with_flags, ANY_REGION,
                      set_global_seed, _set_flags, _get_flags, tmp_dir, Env,
                      current_backend)
from .table import (Table, GroupedTable, range_table, parallelize, read_table,
                    asc, desc, multi_way_zip_join)
from .matrixtable import (MatrixTable, GroupedMatrixTable, range_matrix_table,
                          read_matrix_table)

from .expr.expression import (Expression, ArrayExpression, BooleanExpression,
                              CallExpression, CollectionExpression,
                              DictExpression, Float32Expression,
                              Float64Expression, Int32Expression,
                              Int64Expression, IntervalExpression,
                              LocusExpression, NDArrayExpression,
                              NumericExpression, SetExpression,
                              StringExpression, StructExpression,
                              TupleExpression, to_expr, impute_type)

# function library: exported under both `hl.<fn>` and `hl.expr.functions`
from .expr.typefuncs import ExpressionException
from .expr import functions as _F
from .expr.functions import (
    literal, missing, null, if_else, cond, case, switch, coalesce, or_else,
    or_missing, is_missing, is_defined, bind, rbind, struct, interval, locus,
    locus_interval, parse_locus_interval,
    parse_locus, locus_from_global_position, parse_variant, variant_str, call,
    unphased_diploid_gt_index_call, parse_call, downcode, is_snp, is_mnp,
    is_insertion, is_deletion, is_indel, is_star, is_complex, is_transition,
    is_transversion, allele_type, is_strand_ambiguous, is_valid_contig,
    is_valid_locus, contig_length, min_rep, pl_dosage, gp_dosage, pl_to_gp,
    exp, log, log10, sqrt, expit, logit, floor, ceil, is_nan, is_finite,
    is_infinite, acos, asin, atan, atan2, cos, sin, tan, cosh, sinh, tanh,
    sign, median, mean, product, argmin, argmax, flatten, flatmap,
    delimit, zip_with_index, group_by, starmap, format, json, hamming, entropy,
    reverse_complement, parse_int32, parse_int64, parse_float64, parse_float,
    parse_int, pnorm, qnorm, dnorm, pchisqtail, qchisqtail, ppois, dpois,
    qpois, dbeta, pgenchisq, binom_test, fisher_exact_test, chi_squared_test,
    contingency_table_test, hardy_weinberg_test, rand_unif, rand_bool,
    rand_norm, rand_int32, rand_int64, rand_pois, rand_beta, rand_gamma,
    rand_cat, rand_dirichlet, empty_array, empty_set, empty_dict,
    find, binary_search, uniroot, approx_equal, bit_and, bit_or, bit_xor,
    bit_lshift, bit_rshift, bit_not, bit_count, nanmin, nanmax, corr, shuffle,
    triangle, liftover, get_sequence, mendel_error_code, keyed_intersection,
    keyed_union,
    fold, array_scan, cumulative_sum, gq_from_pl, numeric_allele_type,
    parse_float32, parse_json, repeat, zeros, dchisq, dgamma, pgamma, qgamma,
    phyper, pT, pF, cochran_mantel_haenszel_test, rand_hyper, rand_multi_hyper,
    rand_norm2d,
)

# names that clash with python builtins keep trailing-underscore impls but are
# exported under the hail names:
str = _F.str_
bool = _F.bool_
int = _F.int32
int32 = _F.int32
int64 = _F.int64
float = _F.float64
float32 = _F.float32
float64 = _F.float64
len = _F.len_
range = _F.range_
abs = _F.abs
min = _F.min
max = _F.max
sum = _F.sum_
any = _F.any_
all = _F.all_
map = _F.map_
filter = _F.filter_
zip = _F.zip_
sorted = _F.sorted_
reversed = _F.reversed_
enumerate = _F.enumerate_
array = _F.array
set = _F.set_
dict = _F.dict_
tuple = _F.tuple_
eval = _F.eval_expr
eval_typed = _F.eval_typed
eval_timed = _F.eval_timed
_compare = _F._compare
_locus_windows_per_contig = _F._locus_windows_per_contig
_stream_range = _F._stream_range
_zip_streams = _F._zip_streams
_zip_join_producers = _F._zip_join_producers
_sort_by = _F._sort_by
_values_similar = _F._values_similar

from .expr import aggregators as agg
from .expr import scans as scan
from . import methods as _methods_mod
from .methods import *  # noqa: F401,F403
from .methods.statgen import (_linear_skat, _logistic_skat,
                              _linear_regression_rows_nd,
                              _logistic_regression_rows_nd)
from .methods.pca import (_blanczos_pca, _hwe_normalized_blanczos,
                          _pca_and_moments, _spectral_moments)
from . import linalg
from . import nd
from . import vds
from . import utils
from .utils.hadoop import (hadoop_open, hadoop_copy, hadoop_exists,
                           hadoop_is_file, hadoop_is_dir, hadoop_stat,
                           hadoop_ls, hadoop_scheme_supported,
                           TemporaryDirectory, TemporaryFilename)
from . import experimental
from . import stats
from . import fs
from . import batch as _batch_mod
from .io.native import query_table as query_table, \
    query_matrix_table_rows as query_matrix_table_rows


def reset_global_randomness():
    # reference utils/java.py:125: rewind the static rng uid counter so
    # identical query sequences reproduce identical random streams
    Env._static_rng_uid = 0
    Env.hc()._seed_counter = 0

from . import plot
from . import ggplot

__version__ = '0.1.0'
__pip_version__ = __version__
__revision__ = 'device-native-r1'

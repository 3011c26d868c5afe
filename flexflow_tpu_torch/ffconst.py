"""Framework-wide enums (the subset the serving and training slices use).

A copy of the JAX package's ``ffconst.py`` enums (names, and values where
the JAX package fixes them), so graphs and user code read the same in both
packages. The port never imports the JAX package, so the enums live here.
"""

import enum


class ActiMode(enum.Enum):
    AC_MODE_NONE = 10
    AC_MODE_RELU = 11
    AC_MODE_SIGMOID = 12
    AC_MODE_TANH = 13
    AC_MODE_GELU = 14


class AggrMode(enum.Enum):
    AGGR_MODE_NONE = 20
    AGGR_MODE_SUM = 21
    AGGR_MODE_AVG = 22


class DataType(enum.Enum):
    DT_FLOAT = 40
    DT_DOUBLE = 41
    DT_INT32 = 42
    DT_INT64 = 43
    DT_BOOLEAN = 44
    DT_HALF = 45
    DT_BFLOAT16 = 46
    DT_NONE = 49


class LossType(enum.Enum):
    LOSS_CATEGORICAL_CROSSENTROPY = 50
    LOSS_SPARSE_CATEGORICAL_CROSSENTROPY = 51
    LOSS_MEAN_SQUARED_ERROR_AVG_REDUCE = 52
    LOSS_MEAN_SQUARED_ERROR_SUM_REDUCE = 53
    LOSS_IDENTITY = 54


class CompMode(enum.Enum):
    COMP_MODE_TRAINING = 70
    COMP_MODE_INFERENCE = 71


class MetricsType(enum.Enum):
    METRICS_ACCURACY = 1001
    METRICS_CATEGORICAL_CROSSENTROPY = 1002
    METRICS_SPARSE_CATEGORICAL_CROSSENTROPY = 1004
    METRICS_MEAN_SQUARED_ERROR = 1008
    METRICS_ROOT_MEAN_SQUARED_ERROR = 1016
    METRICS_MEAN_ABSOLUTE_ERROR = 1032


class OperatorType(enum.Enum):
    """Op vocabulary: the names of the JAX package's OperatorType that the
    ported slices build (the values are not shared)."""

    OP_INPUT = enum.auto()
    OP_NOOP = enum.auto()
    OP_LINEAR = enum.auto()
    OP_SIGMOID = enum.auto()
    OP_LAYERNORM = enum.auto()
    OP_RMSNORM = enum.auto()
    OP_EMBEDDING = enum.auto()
    OP_EW_ADD = enum.auto()
    OP_EW_MUL = enum.auto()
    OP_MULTIHEAD_ATTENTION = enum.auto()
    OP_MEAN = enum.auto()

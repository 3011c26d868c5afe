"""Framework-wide enums (the subset the serving and training slices use).

A copy of the JAX package's ``ffconst.py`` enums (names, and values where
the JAX package fixes them), so graphs and user code read the same in both
packages. The port never imports the JAX package, so the enums live here.
"""

import enum

import torch


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


class PoolType(enum.Enum):
    POOL_MAX = 30
    POOL_AVG = 31


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
    OP_CONV2D = enum.auto()
    OP_DROPOUT = enum.auto()
    OP_LINEAR = enum.auto()
    OP_BATCHMATMUL = enum.auto()
    OP_POOL2D = enum.auto()
    OP_RELU = enum.auto()
    OP_SIGMOID = enum.auto()
    OP_TANH = enum.auto()
    OP_ELU = enum.auto()
    OP_GELU = enum.auto()
    OP_FLAT = enum.auto()
    OP_SOFTMAX = enum.auto()
    OP_BATCHNORM = enum.auto()
    OP_LAYERNORM = enum.auto()
    OP_RMSNORM = enum.auto()
    OP_CONCAT = enum.auto()
    OP_SPLIT = enum.auto()
    OP_EMBEDDING = enum.auto()
    OP_EW_ADD = enum.auto()
    OP_EW_MUL = enum.auto()
    OP_EW_SUB = enum.auto()
    OP_EW_DIV = enum.auto()
    OP_EW_MAX = enum.auto()
    OP_EW_MIN = enum.auto()
    OP_SCALAR_MULTIPLY = enum.auto()
    OP_EXP = enum.auto()
    OP_SIN = enum.auto()
    OP_COS = enum.auto()
    OP_POW = enum.auto()
    OP_RSQRT = enum.auto()
    OP_IDENTITY = enum.auto()
    OP_RESHAPE = enum.auto()
    OP_REVERSE = enum.auto()
    OP_TRANSPOSE = enum.auto()
    OP_TOPK = enum.auto()
    OP_MULTIHEAD_ATTENTION = enum.auto()
    OP_CAST = enum.auto()
    OP_PAD = enum.auto()
    OP_MEAN = enum.auto()
    OP_GATHER = enum.auto()
    OP_FUSED = enum.auto()
    OP_LSTM = enum.auto()
    OP_GRU = enum.auto()
    OP_MOE = enum.auto()


#: the torch dtype of each DataType (a Cast's target; the JAX package
#: narrows DT_DOUBLE / DT_INT64 to 32 bits unless jax_enable_x64 is set,
#: the port keeps the width the graph names)
TORCH_DTYPES = {
    DataType.DT_FLOAT: torch.float32,
    DataType.DT_DOUBLE: torch.float64,
    DataType.DT_INT32: torch.int32,
    DataType.DT_INT64: torch.int64,
    DataType.DT_BOOLEAN: torch.bool,
    DataType.DT_HALF: torch.float16,
    DataType.DT_BFLOAT16: torch.bfloat16,
}

"""Row-level lineage inference via predicate pushdown (PredTrace), ported to
PyTorch: the same modules as the reference package's ``core``, with device
scans on a torch device through the hand-written ``pred_filter`` kernel."""
from . import ops
from .cost import CostModel, Decision, PlanRecorder, PlanReport, default_cost_model
from .eager import EagerExecutor, oracle_lineage_for_values
from .executor import ExecResult, Executor
from .expr import (
    Col, Expr, IsIn, LineageAnnotation, Lit, Param, ParamSet, UDFExpr, land,
    lnot, lor,
)
from .iterative import IterativeInference, refine
from .lineage import LineageAnswer, PredTrace
from .plan import (
    LineageInference, LineagePlan, MaterializationPlan, plan_materialization,
)
from .distributed import PartitionExecutor, distributed_refine
from .pushdown import DEFAULT_REGISTRY, Push, Pushdown, PushdownRuleRegistry
from .scan import (
    AtomProgram, LRUCache, NumpyBackend, ScanEngine, TorchBackend,
    prune_zone_maps,
)
from .service import (
    DeadlineExceeded, LineageRequest, LineageService, RequestCancelled,
)
from .store import InSituBackend, IntermediateStore, StoredTable, encode_column
from .table import (
    PartitionedTable, Table, ZoneMaps, build_zone_maps, catalog_from_numpy,
    partition_table,
)

__all__ = [
    "ops", "Col", "Expr", "IsIn", "Lit", "Param", "ParamSet", "land", "lnot",
    "lor", "LineageAnnotation", "UDFExpr", "Table", "Executor", "ExecResult",
    "EagerExecutor",
    "oracle_lineage_for_values", "PredTrace", "LineageAnswer",
    "LineageInference", "LineagePlan", "Pushdown", "Push",
    "PushdownRuleRegistry", "DEFAULT_REGISTRY", "IterativeInference",
    "refine", "ScanEngine", "AtomProgram", "NumpyBackend", "TorchBackend",
    "IntermediateStore", "StoredTable", "InSituBackend", "encode_column",
    "MaterializationPlan", "plan_materialization",
    "PartitionedTable", "ZoneMaps", "partition_table", "build_zone_maps",
    "prune_zone_maps", "PartitionExecutor", "distributed_refine", "LRUCache",
    "catalog_from_numpy",
    "LineageService", "LineageRequest", "DeadlineExceeded", "RequestCancelled",
    "CostModel", "Decision", "PlanRecorder", "PlanReport", "default_cost_model",
]

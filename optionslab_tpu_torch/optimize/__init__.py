"""Hyperparameter search (TPE, Sobol and random samplers, median pruning,
SQLite studies with resume), search spaces and objectives, reproducibility,
``torch.export`` artifacts with an inference engine and a parity validator,
hand-emitted ``.onnx`` files with a NumPy runtime, and the
optimize-and-export pipeline."""

from .export import (
    ExportResult,
    ExportValidator,
    InferenceEngine,
    ModelExporter,
    ValidationReport,
    export_surface_model,
)
from .onnx_emit import (
    OnnxGraphBuilder,
    OnnxLiteRuntime,
    export_mlp_onnx,
    export_surface_model_onnx,
)
from .objectives import (
    get_metric,
    make_calibration_objective,
    make_surface_model_objective,
    make_surrogate_objective,
)
from .reproducibility import (
    compute_data_hash,
    environment_fingerprint,
    get_trial_seed,
    seeded_kfold,
    set_global_seed,
    set_thread_limits,
    trial_key,
)
from .search import (
    FrozenTrial,
    MedianPruner,
    NopPruner,
    OptunaStudyManager,
    RandomSampler,
    SobolSampler,
    StudyManager,
    TPESampler,
    StudyResult,
    StudyStorage,
    Trial,
    TrialPruned,
)
from .spaces import (
    GradientBoostingSearchSpace,
    KernelRidgeSearchSpace,
    MLPSearchSpace,
    SurrogateSearchSpace,
)
from .wrappers import create_mlp_optimizer, create_surrogate_optimizer, optimize_and_export

__all__ = [
    "StudyManager", "OptunaStudyManager", "StudyResult", "StudyStorage",
    "Trial", "FrozenTrial", "TrialPruned", "RandomSampler", "SobolSampler",
    "TPESampler",
    "MedianPruner", "NopPruner",
    "MLPSearchSpace", "GradientBoostingSearchSpace", "KernelRidgeSearchSpace",
    "SurrogateSearchSpace",
    "make_surface_model_objective", "make_surrogate_objective",
    "make_calibration_objective", "get_metric",
    "set_global_seed", "get_trial_seed", "trial_key", "set_thread_limits",
    "compute_data_hash", "seeded_kfold", "environment_fingerprint",
    "ModelExporter", "InferenceEngine", "ExportValidator", "ExportResult",
    "ValidationReport", "export_surface_model",
    "OnnxGraphBuilder", "OnnxLiteRuntime", "export_mlp_onnx",
    "export_surface_model_onnx",
    "create_mlp_optimizer", "create_surrogate_optimizer", "optimize_and_export",
]

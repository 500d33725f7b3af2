"""Glue: one-call optimizers and the optimize-and-export pipeline.

The port of ``optionslab_tpu/optimize/wrappers.py``: ``create_mlp_optimizer``,
``create_surrogate_optimizer`` and ``optimize_and_export`` (search → retrain
the best configuration → ``torch.export`` → validate, optionally an
``.onnx`` twin). Models train on ``device`` (default the card).
"""

from __future__ import annotations

from .export import ExportValidator, InferenceEngine, ModelExporter, export_surface_model
from .objectives import make_surface_model_objective, make_surrogate_objective
from .search import StudyManager
from .spaces import MLPSearchSpace, SurrogateSearchSpace


def create_mlp_optimizer(df, study_name: str = "mlp_study",
                         storage: str = "sqlite:///optionslab_studies.db",
                         n_folds: int = 2, epochs: int = 60, device="cuda", **study_kwargs):
    """(StudyManager, objective) tuned for the MLP surface model."""
    from ..surface.mlp import MLPModel

    space = MLPSearchSpace()
    objective = make_surface_model_objective(MLPModel, space, df, n_folds=n_folds,
                                             epochs=epochs, device=device)
    manager = StudyManager(study_name, storage, **study_kwargs)
    return manager, objective


def create_surrogate_optimizer(study_name: str = "surrogate_study",
                               storage: str = "sqlite:///optionslab_studies.db",
                               n_train: int = 10_000, device="cuda", **study_kwargs):
    space = SurrogateSearchSpace()
    objective = make_surrogate_objective(space, n_train=n_train, device=device)
    manager = StudyManager(study_name, storage, **study_kwargs)
    return manager, objective


def optimize_and_export(df, export_path, n_trials: int = 10,
                        study_name: str = "mlp_export_study",
                        storage: str = "sqlite:///optionslab_studies.db",
                        final_epochs: int = 300, emit_onnx: bool = False, device="cuda"):
    """Search MLP hyperparameters → retrain the best configuration on the
    full data → export the artifact → validate it. ``emit_onnx=True`` also
    writes a parity-checked ``.onnx`` twin beside it (the export path with
    an ``.onnx`` suffix in place of ``.pt2``)."""
    from ..surface.mlp import MLPModel

    manager, objective = create_mlp_optimizer(df, study_name, storage, device=device)
    result = manager.optimize(objective, n_trials=n_trials)
    best = dict(result.best_params)
    width = best.pop("width", 64)
    depth = best.pop("n_layers", 2)
    best["hidden_layers"] = tuple([width] * depth)
    model = MLPModel(epochs=final_epochs, device=device, **{
        k: v for k, v in best.items()
        if k in ("hidden_layers", "dropout_rate", "learning_rate", "batch_size")})
    metrics = model.train(df)
    export_result = export_surface_model(model, export_path)
    out = {
        "study": result,
        "final_metrics": metrics,
        "export": export_result,
        "model": model,
    }
    if emit_onnx:
        from .onnx_emit import export_surface_model_onnx

        onnx_path = str(export_path)
        onnx_path = (onnx_path[:-len(".pt2")] if onnx_path.endswith(".pt2")
                     else onnx_path) + ".onnx"
        out["onnx"] = export_surface_model_onnx(model, onnx_path)
    return out


__all__ = [
    "create_mlp_optimizer",
    "create_surrogate_optimizer",
    "optimize_and_export",
    "ModelExporter",
    "InferenceEngine",
    "ExportValidator",
]

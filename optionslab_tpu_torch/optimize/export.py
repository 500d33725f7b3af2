"""Model export and deployment: ``torch.export`` programs, validation,
inference.

The port of ``optionslab_tpu/optimize/export.py``. The reference serializes
``jax.export`` StableHLO; here the interchange format is a
``torch.export`` program (``torch.export.save``): a self-contained graph,
loadable without the model class. The exporter wraps any tensor function
``fn(x)`` with a dynamic batch dimension, so one artifact serves every
batch size; a JSON sidecar carries the reference's metadata keys.
:class:`InferenceEngine` loads an artifact onto the device it names (the
program records the device it was exported on, and is moved), validates
inputs against the metadata, predicts in chunks and benchmarks latency.
:class:`ExportValidator` holds the loaded program to the live function
across batch sizes.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import time
from typing import Callable, Sequence

import numpy as np
import torch

from ..utils.exceptions import ModelError, ValidationError


@dataclasses.dataclass
class ExportResult:
    path: str
    n_bytes: int
    input_shape: tuple
    input_dtype: str
    metadata: dict


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


class _Fn(torch.nn.Module):
    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


class ModelExporter:
    """Serialize a tensor function (e.g. a trained model's forward)."""

    @staticmethod
    def export(fn: Callable, example_input, path, metadata: dict | None = None,
               batch_polymorphic: bool = True) -> ExportResult:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        x = example_input if isinstance(example_input, torch.Tensor) \
            else torch.as_tensor(np.asarray(example_input))
        dynamic = {"x": {0: torch.export.Dim("batch")}} if batch_polymorphic and x.dim() >= 1 \
            else None
        with torch.no_grad():
            program = torch.export.export(_Fn(fn), (x,), dynamic_shapes=dynamic)
        torch.export.save(program, str(path))
        meta = {
            "format": "torch.export",
            "input_shape": list(x.shape),
            "input_dtype": _dtype_name(x.dtype),
            "batch_polymorphic": batch_polymorphic,
            "created": time.time(),
            **(metadata or {}),
        }
        (path.with_suffix(path.suffix + ".json")).write_text(json.dumps(meta, default=float))
        return ExportResult(str(path), path.stat().st_size, tuple(x.shape),
                            _dtype_name(x.dtype), meta)


class InferenceEngine:
    """Load and run an exported artifact on ``device`` (default the card),
    with input validation and a latency benchmark."""

    def __init__(self, path, device="cuda"):
        from torch.export.passes import move_to_device_pass

        path = pathlib.Path(path)
        if not path.exists():
            raise ModelError(f"exported model not found: {path}")
        self.device = torch.device(device)
        self._module = move_to_device_pass(torch.export.load(str(path)), self.device).module()
        meta_path = path.with_suffix(path.suffix + ".json")
        self.metadata = json.loads(meta_path.read_text()) if meta_path.exists() else {}

    def _validate_input(self, x) -> torch.Tensor:
        x = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        want_dtype = self.metadata.get("input_dtype")
        if want_dtype and _dtype_name(x.dtype) != want_dtype:
            raise ValidationError(f"input dtype {_dtype_name(x.dtype)} != exported {want_dtype}")
        want_shape = self.metadata.get("input_shape")
        if want_shape and not self.metadata.get("batch_polymorphic", False):
            if list(x.shape) != list(want_shape):
                raise ValidationError(f"input shape {tuple(x.shape)} != exported {want_shape}")
        elif want_shape and list(x.shape[1:]) != list(want_shape)[1:]:
            raise ValidationError(
                f"feature shape {tuple(x.shape[1:])} != exported {tuple(want_shape[1:])}")
        return x.to(self.device)

    def _call(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self._module(x)

    def predict(self, x) -> np.ndarray:
        return self._call(self._validate_input(x)).cpu().numpy()

    def predict_batch(self, x, chunk_size: int = 8192) -> np.ndarray:
        """Chunked prediction for huge inputs."""
        outs = [self.predict(x[i:i + chunk_size]) for i in range(0, len(x), chunk_size)]
        return np.concatenate(outs, axis=0)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def benchmark(self, x, iters: int = 50) -> dict:
        """Latency stats (each call synchronised)."""
        x = self._validate_input(x)
        self._call(x)
        self._sync()
        samples = []
        for _ in range(iters):
            t0 = time.perf_counter()
            self._call(x)
            self._sync()
            samples.append((time.perf_counter() - t0) * 1e3)
        samples.sort()
        n = len(samples)
        return {"mean_ms": sum(samples) / n, "p50_ms": samples[n // 2],
                "p95_ms": samples[min(n - 1, int(0.95 * n))], "iters": n}


@dataclasses.dataclass
class ValidationReport:
    passed: bool
    max_abs_error: float
    mean_abs_error: float
    max_rel_error: float
    batch_sizes: list

    def summary(self) -> str:
        status = "PASSED" if self.passed else "FAILED"
        return (f"export validation {status}: max|err|={self.max_abs_error:.3e} "
                f"mean|err|={self.mean_abs_error:.3e} max rel={self.max_rel_error:.3e} "
                f"batches={self.batch_sizes}")


class ExportValidator:
    """Live-vs-exported parity across batch sizes."""

    def __init__(self, atol: float = 1e-5, rtol: float = 1e-4):
        self.atol = atol
        self.rtol = rtol

    def validate(self, fn: Callable, engine: InferenceEngine, inputs,
                 device=None) -> ValidationReport:
        return self.validate_batch_sizes(fn, engine, [inputs], device)

    def validate_batch_sizes(self, fn: Callable, engine: InferenceEngine,
                             input_batches: Sequence, device=None) -> ValidationReport:
        """``fn`` runs on ``device`` (default the engine's), the engine on
        its own."""
        dev = torch.device(device) if device is not None else engine.device
        max_abs = mean_abs = max_rel = 0.0
        sizes = []
        for x in input_batches:
            x = np.asarray(x)
            sizes.append(len(x))
            with torch.no_grad():
                native = fn(torch.as_tensor(x, device=dev)).cpu().numpy()
            restored = engine.predict(x)
            err = np.abs(native - restored)
            rel = err / np.maximum(np.abs(native), 1e-12)
            max_abs = max(max_abs, float(err.max()))
            mean_abs = max(mean_abs, float(err.mean()))
            max_rel = max(max_rel, float(rel.max()))
        passed = max_abs <= self.atol or max_rel <= self.rtol
        return ValidationReport(passed, max_abs, mean_abs, max_rel, sizes)


def surface_forward(model) -> Callable:
    """A trained surface model's forward on the RAW feature matrix: the
    model's ``export_forward()`` where it has one, else scaler + MLP."""
    if getattr(model, "params", None) is None:
        raise ModelError("model must be trained before export")
    if hasattr(model, "export_forward"):
        return model.export_forward()
    from ..surface.nn_core import apply_mlp

    dev = model.params[0]["w"].device
    mean = torch.as_tensor(np.asarray(model.scaler.mean_, np.float32), device=dev)
    scale = torch.as_tensor(np.asarray(model.scaler.scale_, np.float32), device=dev)
    params = model.params
    # the forward the model predicts with (the surface nets default to
    # layernorm off)
    layernorm = bool(getattr(model, "layernorm", True))

    def fn(x):
        return apply_mlp(params, (x - mean) / scale, layernorm=layernorm)

    return fn


def export_surface_model(model, path, example_df=None) -> ExportResult:
    """Export a trained surface model's forward (preprocessing in the graph)
    and hold the artifact to the live model on the model's device."""
    fn = surface_forward(model)
    dev = model.params[0]["w"].device
    n_feat = len(model.feature_columns)
    example = torch.zeros((4, n_feat), dtype=torch.float32, device=dev)
    result = ModelExporter.export(fn, example, path,
                                  metadata={"model": type(model).__name__,
                                            "features": model.feature_columns})
    x = np.random.default_rng(0).normal(size=(16, n_feat)).astype(np.float32)
    report = ExportValidator().validate(fn, InferenceEngine(path, device=dev), x)
    if not report.passed:
        raise ModelError(f"export failed validation: {report.summary()}")
    return result

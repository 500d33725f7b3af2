"""Real ``.onnx`` artifact emission — no ``onnx`` package required.

The port of ``optionslab_tpu/optimize/onnx_emit.py`` (pure Python, so it
emits the same graph; only the producer name differs). ONNX is a protobuf
message, and the protobuf wire format is simple enough to emit by hand: this
module serializes a valid ONNX ModelProto (ir_version 8, default opset 17)
for the MLP pipelines of ``surface.nn_core``:

    y = MLP_params( (x - mean) / scale )

with hidden layers ``Gemm -> [LayerNormalization] -> activation`` and a linear
output ``Gemm`` — exactly ``surface.nn_core.apply_mlp`` (GELU in its tanh
form, emitted as primitive ops so any opset-13+ runtime can execute it).

Validation is self-contained: a minimal protobuf reader plus a pure-NumPy
executor (:class:`OnnxLiteRuntime`) round-trips the artifact and checks
parity against the live forward. If an ``onnx`` package is present,
``onnx.load`` / ``checker`` work on these files as they are.

Two defects of the reference are not copied: ``mean`` without ``scale`` (or
``scale`` without ``mean``) raises :class:`ValidationError`, and the runtime
raises :class:`ModelError` on a Gemm with an ``alpha``, ``beta``, ``transA``
or ``transB`` it does not execute (the reference ignores them).

Wire-format notes (public onnx.proto3 schema): field numbers are stable —
ModelProto{ir_version=1, producer_name=2, producer_version=3, model_version=5,
doc_string=6, graph=7, opset_import=8, metadata_props=14};
GraphProto{node=1, name=2, initializer=5, doc_string=10, input=11, output=12};
NodeProto{input=1, output=2, name=3, op_type=4, attribute=5};
AttributeProto{name=1, f=2, i=3, type=20 (FLOAT=1, INT=2)};
TensorProto{dims=1, data_type=2, name=8, raw_data=9};
ValueInfoProto{name=1, type=2}; TypeProto{tensor_type=1};
Tensor{elem_type=1, shape=2}; TensorShapeProto{dim=1};
Dimension{dim_value=1, dim_param=2}; StringStringEntry{key=1, value=2}.
"""

from __future__ import annotations

import json
import math
import pathlib
import struct
from typing import Sequence

import numpy as np
import torch

from ..utils.exceptions import ModelError, ValidationError

PRODUCER = "optionslab_tpu_torch"
_FLOAT = 1   # TensorProto.DataType.FLOAT
_GELU_C0 = 0.044715
_GELU_C1 = math.sqrt(2.0 / math.pi)


# ---------------------------------------------------------------------------
# protobuf wire-format primitives (writer)
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_varint(field: int, value: int) -> bytes:
    return _key(field, 0) + _varint(value)


def _f_bytes(field: int, data: bytes) -> bytes:
    return _key(field, 2) + _varint(len(data)) + data


def _f_str(field: int, s: str) -> bytes:
    return _f_bytes(field, s.encode("utf-8"))


def _f_packed_varints(field: int, values: Sequence[int]) -> bytes:
    payload = b"".join(_varint(v) for v in values)
    return _f_bytes(field, payload)


def _f_float(field: int, value: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", value)


# ---------------------------------------------------------------------------
# ONNX message builders
# ---------------------------------------------------------------------------

def _tensor_proto(name: str, arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    msg = _f_packed_varints(1, list(arr.shape))          # dims
    msg += _f_varint(2, _FLOAT)                          # data_type
    msg += _f_str(8, name)                               # name
    msg += _f_bytes(9, arr.tobytes())                    # raw_data (LE f32)
    return msg


def _value_info(name: str, shape, batch_param: str | None = "b") -> bytes:
    dims = b""
    for i, d in enumerate(shape):
        if d is None:
            dim = _f_str(2, batch_param or "b")          # dim_param
        else:
            dim = _f_varint(1, int(d))                   # dim_value
        dims += _f_bytes(1, dim)
    tensor = _f_varint(1, _FLOAT) + _f_bytes(2, dims)    # elem_type, shape
    type_proto = _f_bytes(1, tensor)                     # tensor_type
    return _f_str(1, name) + _f_bytes(2, type_proto)


def _attr_float(name: str, v: float) -> bytes:
    return _f_str(1, name) + _f_float(2, v) + _f_varint(20, 1)   # type FLOAT


def _attr_int(name: str, v: int) -> bytes:
    return _f_str(1, name) + _f_varint(3, v) + _f_varint(20, 2)  # type INT


def _node(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
          name: str = "", attrs: Sequence[bytes] = ()) -> bytes:
    msg = b"".join(_f_str(1, i) for i in inputs)
    msg += b"".join(_f_str(2, o) for o in outputs)
    if name:
        msg += _f_str(3, name)
    msg += _f_str(4, op_type)
    msg += b"".join(_f_bytes(5, a) for a in attrs)
    return msg


class OnnxGraphBuilder:
    """Incremental ONNX GraphProto builder with ModelProto serialization."""

    def __init__(self, name: str = PRODUCER):
        self.name = name
        self._nodes: list[bytes] = []
        self._inits: list[bytes] = []
        self._inputs: list[bytes] = []
        self._outputs: list[bytes] = []
        self._n = 0

    def fresh(self, hint: str) -> str:
        self._n += 1
        return f"{hint}_{self._n}"

    def initializer(self, hint: str, arr: np.ndarray) -> str:
        name = self.fresh(hint)
        self._inits.append(_tensor_proto(name, np.asarray(arr)))
        return name

    def node(self, op_type: str, inputs: Sequence[str], out_hint: str,
             attrs: Sequence[bytes] = ()) -> str:
        out = self.fresh(out_hint)
        self._nodes.append(_node(op_type, inputs, [out],
                                 name=f"{op_type}_{self._n}", attrs=attrs))
        return out

    def set_input(self, name: str, shape):
        self._inputs.append(_value_info(name, shape))

    def set_output(self, name: str, shape):
        self._outputs.append(_value_info(name, shape))

    def serialize(self, *, doc: str = "", metadata: dict | None = None,
                  opset: int = 17, ir_version: int = 8) -> bytes:
        graph = b"".join(_f_bytes(1, n) for n in self._nodes)
        graph += _f_str(2, self.name)
        graph += b"".join(_f_bytes(5, t) for t in self._inits)
        if doc:
            graph += _f_str(10, doc)
        graph += b"".join(_f_bytes(11, v) for v in self._inputs)
        graph += b"".join(_f_bytes(12, v) for v in self._outputs)

        opset_msg = _f_str(1, "") + _f_varint(2, opset)  # default domain
        model = _f_varint(1, ir_version)
        model += _f_str(2, PRODUCER)
        model += _f_str(3, "1.0")
        model += _f_varint(5, 1)
        if doc:
            model += _f_str(6, doc)
        model += _f_bytes(7, graph)
        model += _f_bytes(8, opset_msg)
        for k, v in (metadata or {}).items():
            entry = _f_str(1, str(k)) + _f_str(2, json.dumps(v, default=float)
                                               if not isinstance(v, str) else v)
            model += _f_bytes(14, entry)
        return model


# ---------------------------------------------------------------------------
# MLP pipeline -> ONNX graph
# ---------------------------------------------------------------------------

def _emit_gelu_tanh(g: OnnxGraphBuilder, x: str) -> str:
    """GELU, tanh form: 0.5*x*(1+tanh(c1*(x + c0*x^3)))."""
    c0 = g.initializer("gelu_c0", np.float32(_GELU_C0))
    c1 = g.initializer("gelu_c1", np.float32(_GELU_C1))
    half = g.initializer("half", np.float32(0.5))
    one = g.initializer("one", np.float32(1.0))
    x2 = g.node("Mul", [x, x], "x2")
    x3 = g.node("Mul", [x2, x], "x3")
    t = g.node("Mul", [x3, c0], "gt")
    t = g.node("Add", [x, t], "gt")
    t = g.node("Mul", [t, c1], "gt")
    t = g.node("Tanh", [t], "gt")
    t = g.node("Add", [t, one], "gt")
    t = g.node("Mul", [x, t], "gt")
    return g.node("Mul", [t, half], "gelu")


def _emit_activation(g: OnnxGraphBuilder, x: str, kind: str) -> str:
    if kind == "gelu_tanh":
        return _emit_gelu_tanh(g, x)
    if kind == "tanh":
        return g.node("Tanh", [x], "act")
    if kind == "relu":
        return g.node("Relu", [x], "act")
    raise ValidationError(f"unsupported ONNX activation {kind!r}; "
                          "choose gelu_tanh|tanh|relu")


def export_mlp_onnx(params, path, *, mean=None, scale=None,
                    layernorm: bool = False, ln_eps: float = 1e-6,
                    activation: str = "gelu_tanh",
                    out_scale=None, out_mean=None,
                    metadata: dict | None = None,
                    doc: str = "") -> dict:
    """Write ``(x-mean)/scale -> apply_mlp(params) [*out_scale +out_mean]``
    as a real .onnx file.

    ``params`` is the ``surface.nn_core`` layout: a list of dicts (of
    tensors on any device, or arrays) with ``w (fan_in, fan_out)``, ``b``,
    and (when ``layernorm``) ``ln_scale``/``ln_bias``; the optional output affine de-standardizes multi-head
    targets (the MC surrogate's per-head scaling). Returns a manifest dict
    (also written as a ``.json`` sidecar, mirroring
    ``ModelExporter.export``)."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if (mean is None) != (scale is None):
        raise ValidationError("mean and scale standardize the input together: "
                              "give both or neither")
    layers = [{k: _numpy(v) for k, v in layer.items()} for layer in params]
    if not layers:
        raise ValidationError("params must contain at least one layer")
    d_in = layers[0]["w"].shape[0]
    d_out = layers[-1]["w"].shape[1]

    g = OnnxGraphBuilder("optionslab_mlp")
    g.set_input("x", (None, d_in))
    h = "x"
    if mean is not None:
        m = g.initializer("mean", np.reshape(mean, (d_in,)))
        s = g.initializer("scale", np.reshape(scale, (d_in,)))
        h = g.node("Sub", [h, m], "xc")
        h = g.node("Div", [h, s], "xs")
    n = len(layers)
    for i, layer in enumerate(layers):
        w = g.initializer(f"w{i}", layer["w"])
        b = g.initializer(f"b{i}", layer["b"])
        h = g.node("Gemm", [h, w, b], f"h{i}")
        if i < n - 1:
            if layernorm:
                lns = g.initializer(f"ln_scale{i}", layer["ln_scale"])
                lnb = g.initializer(f"ln_bias{i}", layer["ln_bias"])
                h = g.node("LayerNormalization", [h, lns, lnb], f"ln{i}",
                           attrs=[_attr_int("axis", -1),
                                  _attr_float("epsilon", ln_eps)])
            h = _emit_activation(g, h, activation)
    if out_scale is not None:
        ys = g.initializer("out_scale", np.reshape(out_scale, (d_out,)))
        h = g.node("Mul", [h, ys], "yscaled")
    if out_mean is not None:
        ym = g.initializer("out_mean", np.reshape(out_mean, (d_out,)))
        h = g.node("Add", [h, ym], "yshift")
    # final output must carry the graph-output name
    g._nodes.append(_node("Identity", [h], ["y"], name="out"))
    g.set_output("y", (None, d_out))

    manifest = {
        "format": "onnx", "ir_version": 8, "opset": 17,
        "input_shape": [None, int(d_in)], "output_shape": [None, int(d_out)],
        "layernorm": bool(layernorm), "activation": activation,
        "standardized_input": mean is not None,
        "output_affine": out_scale is not None or out_mean is not None,
        **(metadata or {}),
    }
    data = g.serialize(doc=doc, metadata=manifest)
    path.write_bytes(data)
    path.with_suffix(path.suffix + ".json").write_text(
        json.dumps(manifest, default=float))
    manifest["path"] = str(path)
    manifest["n_bytes"] = len(data)
    return manifest


# ---------------------------------------------------------------------------
# protobuf wire-format reader + pure-NumPy executor
# ---------------------------------------------------------------------------

def _parse_fields(data: bytes):
    """Generic wire parse: yields (field, wire, value) — value is int for
    varint/fixed, bytes for length-delimited."""
    i, n = 0, len(data)
    while i < n:
        tag, i = _read_varint(data, i)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            v, i = _read_varint(data, i)
        elif wire == 2:
            ln, i = _read_varint(data, i)
            v = data[i:i + ln]
            i += ln
        elif wire == 5:
            v = struct.unpack_from("<I", data, i)[0]
            i += 4
        elif wire == 1:
            v = struct.unpack_from("<Q", data, i)[0]
            i += 8
        else:
            raise ModelError(f"unsupported protobuf wire type {wire}")
        yield field, wire, v


def _read_varint(data: bytes, i: int):
    shift = out = 0
    while True:
        b = data[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _parse_tensor(data: bytes):
    dims, name, raw, dtype, floats = [], "", b"", _FLOAT, []
    for field, wire, v in _parse_fields(data):
        if field == 1:
            if wire == 2:  # packed
                j = 0
                while j < len(v):
                    d, j = _read_varint(v, j)
                    dims.append(d)
            else:
                dims.append(v)
        elif field == 2:
            dtype = v
        elif field == 4:  # float_data (packed or repeated fixed32)
            if wire == 2:
                floats.extend(struct.unpack(f"<{len(v) // 4}f", v))
            else:
                floats.append(struct.unpack("<f", struct.pack("<I", v))[0])
        elif field == 8:
            name = v.decode("utf-8")
        elif field == 9:
            raw = v
    if dtype != _FLOAT:
        raise ModelError(f"OnnxLiteRuntime supports float32 tensors only "
                         f"(got data_type={dtype})")
    if raw:
        arr = np.frombuffer(raw, dtype="<f4")
    else:
        arr = np.asarray(floats, np.float32)
    return name, arr.reshape(dims) if dims else arr.reshape(())


def _parse_attr(data: bytes):
    name, f, i_, typ = "", 0.0, 0, 0
    for field, wire, v in _parse_fields(data):
        if field == 1:
            name = v.decode("utf-8")
        elif field == 2:
            f = struct.unpack("<f", struct.pack("<I", v))[0]
        elif field == 3:
            i_ = v if v < (1 << 63) else v - (1 << 64)
        elif field == 20:
            typ = v
    return name, (f if typ == 1 else i_)


def _parse_node(data: bytes):
    inputs, outputs, op, attrs = [], [], "", {}
    for field, wire, v in _parse_fields(data):
        if field == 1:
            inputs.append(v.decode("utf-8"))
        elif field == 2:
            outputs.append(v.decode("utf-8"))
        elif field == 4:
            op = v.decode("utf-8")
        elif field == 5:
            k, val = _parse_attr(v)
            attrs[k] = val
    return op, inputs, outputs, attrs


class OnnxLiteRuntime:
    """Parse + execute the ONNX files this module emits, with pure NumPy.

    Deliberately minimal (the op set ``export_mlp_onnx`` uses, plus MatMul/
    Sqrt/Erf for forward-compat): a validator standing in for onnxruntime,
    with its inference surface (load, validate input, predict)."""

    _BINOPS = {"Add": np.add, "Sub": np.subtract, "Mul": np.multiply,
               "Div": np.divide, "MatMul": np.matmul}

    def __init__(self, path):
        path = pathlib.Path(path)
        if not path.exists():
            raise ModelError(f"onnx artifact not found: {path}")
        self.nodes, self.tensors = [], {}
        self.input_names, self.output_names = [], []
        self.metadata = {}
        graph = None
        for field, wire, v in _parse_fields(path.read_bytes()):
            if field == 7:
                graph = v
            elif field == 14:
                kv = dict()
                for f2, w2, v2 in _parse_fields(v):
                    kv[f2] = v2.decode("utf-8")
                self.metadata[kv.get(1, "")] = kv.get(2, "")
        if graph is None:
            raise ModelError("no GraphProto in model file")
        for field, wire, v in _parse_fields(graph):
            if field == 1:
                self.nodes.append(_parse_node(v))
            elif field == 5:
                name, arr = _parse_tensor(v)
                self.tensors[name] = arr
            elif field == 11:
                self.input_names.append(self._vi_name(v))
            elif field == 12:
                self.output_names.append(self._vi_name(v))

    @staticmethod
    def _vi_name(data: bytes) -> str:
        for field, wire, v in _parse_fields(data):
            if field == 1:
                return v.decode("utf-8")
        return ""

    def predict(self, x) -> np.ndarray:
        x = np.asarray(x, np.float32)
        if len(self.input_names) != 1:
            raise ValidationError("expected exactly one graph input")
        env = dict(self.tensors)
        env[self.input_names[0]] = x
        for op, inputs, outputs, attrs in self.nodes:
            a = [env[i] for i in inputs]
            if op in self._BINOPS:
                out = self._BINOPS[op](a[0], a[1])
            elif op == "Gemm":
                _check_gemm(attrs)
                out = a[0] @ a[1] + (a[2] if len(a) > 2 else 0.0)
            elif op == "Tanh":
                out = np.tanh(a[0])
            elif op == "Relu":
                out = np.maximum(a[0], 0.0)
            elif op == "Sqrt":
                out = np.sqrt(a[0])
            elif op == "Erf":
                out = _erf_np(a[0])
            elif op == "Identity":
                out = a[0]
            elif op == "LayerNormalization":
                axis = int(attrs.get("axis", -1))
                eps = float(attrs.get("epsilon", 1e-5))
                mu = a[0].mean(axis=axis, keepdims=True)
                var = a[0].var(axis=axis, keepdims=True)
                out = (a[0] - mu) / np.sqrt(var + eps)
                out = out * a[1] + (a[2] if len(a) > 2 else 0.0)
            else:
                raise ModelError(f"OnnxLiteRuntime: unsupported op {op!r}")
            env[outputs[0]] = np.asarray(out, np.float32)
        return env[self.output_names[0]]


def _erf_np(x):
    # Abramowitz-Stegun 7.1.26 (|err| < 1.5e-7) — numpy has no erf
    sign = np.sign(x)
    x = np.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * x)
    poly = t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))
    return sign * (1.0 - poly * np.exp(-x * x))


# ---------------------------------------------------------------------------
# façade: surface-model export + round-trip parity
# ---------------------------------------------------------------------------

def _numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def _check_gemm(attrs: dict) -> None:
    """The runtime executes Gemm as ``A @ B + C``: any other alpha, beta or
    transposition is refused rather than ignored."""
    want = {"alpha": 1.0, "beta": 1.0, "transA": 0, "transB": 0}
    bad = {k: attrs[k] for k in want if k in attrs and attrs[k] != want[k]}
    if bad:
        raise ModelError(f"OnnxLiteRuntime: unsupported Gemm attributes {bad}")


def export_surface_model_onnx(model, path, atol: float = 2e-5) -> dict:
    """ONNX twin of ``export_surface_model``: emit the trained surface MLP
    (scaler folded in as graph ops) and parity-check the artifact against
    the live forward via :class:`OnnxLiteRuntime`.

    Works for any model exposing the ``nn_core`` params: ``params``,
    ``scaler``, ``feature_columns``, ``layernorm``."""
    from ..surface.nn_core import apply_mlp

    if getattr(model, "params", None) is None:
        raise ModelError("model must be trained before export")
    layernorm = bool(getattr(model, "layernorm", True))
    manifest = export_mlp_onnx(
        model.params, path,
        mean=np.asarray(model.scaler.mean_, np.float32),
        scale=np.asarray(model.scaler.scale_, np.float32),
        layernorm=layernorm,
        metadata={"model": type(model).__name__,
                  "features": list(model.feature_columns)},
        doc=f"{type(model).__name__} forward (scaler folded in)")

    rng = np.random.default_rng(0)
    x = rng.normal(size=(16, len(model.feature_columns))).astype(np.float32)
    mean = np.asarray(model.scaler.mean_, np.float32)
    scale = np.asarray(model.scaler.scale_, np.float32)
    dev = model.params[0]["w"].device
    with torch.no_grad():
        native = apply_mlp(model.params, torch.as_tensor((x - mean) / scale, device=dev),
                           layernorm=layernorm).cpu().numpy()
    restored = OnnxLiteRuntime(path).predict(x)
    err = float(np.max(np.abs(native - restored)))
    if err > atol:
        raise ModelError(f"onnx export failed round-trip parity: "
                         f"max|err|={err:.3e} > {atol}")
    manifest["roundtrip_max_abs_err"] = err
    return manifest

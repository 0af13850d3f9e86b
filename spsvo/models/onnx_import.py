"""ONNX weight/graph importer — pure Python, no `onnx` dependency.

Decodes the protobuf wire format of the reference's bundled SuperPoint-family
ONNX exports (reference src/odml_visual_odometry/models/sp_{mbv1,mbv2,squeeze}_b{1,2}.onnx;
the offline-compiler role of scripts/engine_generation.py:13-58 is replaced by
XLA jit compilation keyed on the imported graph) and builds:

  * a params pytree (dict name -> jnp array, conv weights converted
    OIHW -> HWIO for the NHWC layout), and
  * a jittable `apply(params, images_nhwc)` interpreter covering the op set
    the bundled graphs use: Conv (incl. grouped/depthwise), Relu, MaxPool,
    BatchNormalization, Add, Concat, ReduceL2, Div.

The interpreter runs in NHWC throughout: channel-axis attributes (Concat
axis=1, ReduceL2 axes=[1]) are remapped to the last axis.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

# --------------------------------------------------------------------------
# protobuf wire-format decoding
# --------------------------------------------------------------------------

_ONNX_DTYPES = {1: np.float32, 6: np.int32, 7: np.int64, 11: np.float64,
                10: np.float16}


def _read_varint(buf: bytes, pos: int):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _iter_fields(buf: bytes):
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fnum, wtype = tag >> 3, tag & 7
        if wtype == 0:
            val, pos = _read_varint(buf, pos)
        elif wtype == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wtype == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wtype == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wtype}")
        yield fnum, wtype, val


def _zigzag_ok(v: int) -> int:
    # onnx ints are plain (non-zigzag) varints; negative values come as
    # 64-bit two's complement.
    return v - (1 << 64) if v >= (1 << 63) else v


def _parse_tensor(buf: bytes):
    dims: List[int] = []
    name = ""
    dtype = 1
    raw = b""
    floats: List[float] = []
    ints: List[int] = []
    for fnum, wt, val in _iter_fields(buf):
        if fnum == 1:
            dims.append(_zigzag_ok(val))
        elif fnum == 2:
            dtype = val
        elif fnum == 4:
            if wt == 2:  # packed floats
                floats.extend(struct.unpack(f"<{len(val)//4}f", val))
            else:
                floats.append(struct.unpack("<f", val)[0])
        elif fnum == 7:
            if wt == 2:  # packed int64
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    ints.append(_zigzag_ok(v))
            else:
                ints.append(_zigzag_ok(val))
        elif fnum == 8:
            name = val.decode()
        elif fnum == 9:
            raw = val
    np_dtype = _ONNX_DTYPES.get(dtype, np.float32)
    if raw:
        arr = np.frombuffer(raw, dtype=np_dtype).reshape(dims)
    elif floats:
        arr = np.array(floats, dtype=np_dtype).reshape(dims)
    elif ints:
        arr = np.array(ints, dtype=np_dtype).reshape(dims)
    else:
        arr = np.zeros(dims, dtype=np_dtype)
    return name, arr.copy()


def _parse_attr(buf: bytes) -> Dict[str, Any]:
    a: Dict[str, Any] = {}
    for fnum, wt, val in _iter_fields(buf):
        if fnum == 1:
            a["name"] = val.decode()
        elif fnum == 2:
            a["f"] = struct.unpack("<f", val)[0]
        elif fnum == 3:
            a["i"] = _zigzag_ok(val)
        elif fnum == 4:
            a["s"] = val.decode(errors="replace")
        elif fnum == 5:
            a["t"] = _parse_tensor(val)[1]
        elif fnum == 7:
            if wt == 2:
                a.setdefault("floats", []).extend(
                    struct.unpack(f"<{len(val)//4}f", val))
            else:
                a.setdefault("floats", []).append(struct.unpack("<f", val)[0])
        elif fnum == 8:
            if wt == 2:
                p = 0
                while p < len(val):
                    v, p = _read_varint(val, p)
                    a.setdefault("ints", []).append(_zigzag_ok(v))
            else:
                a.setdefault("ints", []).append(_zigzag_ok(val))
    return a


@dataclasses.dataclass
class OnnxNode:
    op: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any]

    def attr(self, name: str, default=None):
        a = self.attrs.get(name)
        if a is None:
            return default
        for key in ("ints", "i", "f", "floats", "s", "t"):
            if key in a:
                return a[key]
        return default


def _parse_node(buf: bytes) -> OnnxNode:
    inputs: List[str] = []
    outputs: List[str] = []
    op = ""
    attrs: Dict[str, Any] = {}
    for fnum, wt, val in _iter_fields(buf):
        if fnum == 1:
            inputs.append(val.decode())
        elif fnum == 2:
            outputs.append(val.decode())
        elif fnum == 4:
            op = val.decode()
        elif fnum == 5:
            a = _parse_attr(val)
            attrs[a.get("name", "")] = a
    return OnnxNode(op, inputs, outputs, attrs)


def _parse_io_name(buf: bytes) -> str:
    for fnum, wt, val in _iter_fields(buf):
        if fnum == 1:
            return val.decode()
    return ""


@dataclasses.dataclass
class OnnxGraph:
    nodes: List[OnnxNode]
    initializers: Dict[str, np.ndarray]
    input_names: List[str]
    output_names: List[str]


def parse_onnx(path: str) -> OnnxGraph:
    buf = open(path, "rb").read()
    graph_buf: Optional[bytes] = None
    for fnum, wt, val in _iter_fields(buf):
        if fnum == 7:
            graph_buf = val
            break
    if graph_buf is None:
        raise ValueError(f"{path}: no graph field in ModelProto")
    nodes: List[OnnxNode] = []
    inits: Dict[str, np.ndarray] = {}
    input_names: List[str] = []
    output_names: List[str] = []
    for fnum, wt, val in _iter_fields(graph_buf):
        if fnum == 1:
            nodes.append(_parse_node(val))
        elif fnum == 5:
            name, arr = _parse_tensor(val)
            inits[name] = arr
        elif fnum == 11:
            input_names.append(_parse_io_name(val))
        elif fnum == 12:
            output_names.append(_parse_io_name(val))
    # graph inputs include initializers in some exports; keep only real inputs
    input_names = [n for n in input_names if n not in inits]
    return OnnxGraph(nodes, inits, input_names, output_names)


# --------------------------------------------------------------------------
# NHWC JAX interpreter
# --------------------------------------------------------------------------

_SUPPORTED_OPS = {"Conv", "Relu", "MaxPool", "BatchNormalization", "Add",
                  "Concat", "ReduceL2", "Div", "Clip", "Mul", "Sub"}


def build_params(graph: OnnxGraph) -> Dict[str, np.ndarray]:
    """Convert initializers to the NHWC/HWIO layout.

    Conv weights (OIHW) -> HWIO. Everything else passes through.
    """
    conv_weights = {n.inputs[1] for n in graph.nodes if n.op == "Conv"}
    params: Dict[str, np.ndarray] = {}
    for name, arr in graph.initializers.items():
        if name in conv_weights:
            params[name] = np.transpose(arr, (2, 3, 1, 0)).astype(np.float32)
        else:
            params[name] = arr.astype(np.float32)
    return params


def _conv(x, w, b, node: OnnxNode, compute_dtype, w_scale=None,
          a_scale=None, x_q=None):
    pads = node.attr("pads", [0, 0, 0, 0])
    strides = [int(s) for s in node.attr("strides", [1, 1])]
    dilations = [int(d) for d in node.attr("dilations", [1, 1])]
    groups = int(node.attr("group", 1))
    padding = ((int(pads[0]), int(pads[2])), (int(pads[1]), int(pads[3])))
    if w.dtype == jnp.int8:
        from spsvo.models.quantize import int8_conv
        y = int8_conv(x.astype(jnp.float32), w, w_scale, strides, padding,
                      dilations, groups, a_scale, x_q=x_q)
    else:
        y = jax.lax.conv_general_dilated(
            x.astype(compute_dtype), w.astype(compute_dtype),
            window_strides=strides, padding=padding, rhs_dilation=dilations,
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=groups,
            preferred_element_type=jnp.float32)
    if b is not None:
        y = y + b.astype(jnp.float32)
    return y


def _maxpool(x, node: OnnxNode):
    ks = [int(k) for k in node.attr("kernel_shape", [2, 2])]
    strides = [int(s) for s in node.attr("strides", ks)]
    pads = node.attr("pads", [0, 0, 0, 0])
    padding = ((0, 0), (int(pads[0]), int(pads[2])),
               (int(pads[1]), int(pads[3])), (0, 0))
    init = (x.dtype.type(jnp.iinfo(x.dtype).min)
            if jnp.issubdtype(x.dtype, jnp.integer) else -jnp.inf)
    return jax.lax.reduce_window(
        x, init, jax.lax.max,
        window_dimensions=(1, ks[0], ks[1], 1),
        window_strides=(1, strides[0], strides[1], 1),
        padding=padding)


def make_apply(graph: OnnxGraph, compute_dtype=jnp.float32,
               capture_conv_inputs: bool = False,
               capture_quantile: Optional[float] = None):
    """Build `apply(params, x_nhwc) -> dict[name, array]` from the graph.

    `x_nhwc` is (B, H, W, C) float32 in [0, 1]. Outputs are NHWC as well; the
    channel axis of ONNX NCHW attrs is remapped to -1. The convolution trunk
    runs in `compute_dtype` (bf16 mirrors the reference's FP16 engines) with
    fp32 accumulation; head outputs are fp32.

    `capture_conv_inputs=True` makes apply return
    `(outputs, {conv_weight_name: absmax_of_its_input})` — the hook int8
    static calibration uses (quantize.calibrate_activation_scales).
    `capture_quantile` (e.g. 0.999) captures that |x| quantile instead of
    the absmax — percentile clipping trades rare-outlier saturation for a
    finer quantization grid on the bulk of the distribution.
    """
    nodes = list(graph.nodes)
    output_names = list(graph.output_names)

    # Fuse (ReduceL2 -> Div) pairs into one stable L2-normalisation:
    # x * rsqrt(sum(x^2) + eps). Numerically identical in inference (norms
    # are O(1..100); golden-tested vs cv2.dnn), but the fused form has a
    # bounded backward — the raw x/||x|| Div explodes gradients wherever a
    # ReLU-dead descriptor column drives ||x|| -> 0, which NaN'd training.
    consumers: Dict[str, int] = {}
    for node in nodes:
        for name in node.inputs:
            consumers[name] = consumers.get(name, 0) + 1
    l2_nodes: Dict[str, OnnxNode] = {
        n.outputs[0]: n for n in nodes
        if (n.op == "ReduceL2" and list(n.attr("axes", [1])) == [1]
            and bool(n.attr("keepdims", 1)))}
    fusable: Dict[str, str] = {}   # ReduceL2 output -> its input, fusable
    for node in nodes:
        # fuse only the exact x / ||x|| pattern with a single-use norm
        if (node.op == "Div" and node.inputs[1] in l2_nodes
                and l2_nodes[node.inputs[1]].inputs[0] == node.inputs[0]
                and consumers.get(node.inputs[1], 0) == 1
                and node.inputs[1] not in output_names):
            fusable[node.inputs[1]] = node.inputs[0]
    fused: List[OnnxNode] = []
    for node in nodes:
        if node.op == "ReduceL2" and node.outputs[0] in fusable:
            continue  # consumed by the matching Div below
        if (node.op == "Div" and node.inputs[1] in fusable
                and fusable[node.inputs[1]] == node.inputs[0]):
            fused.append(OnnxNode("L2Normalize", [node.inputs[0]],
                                  [node.outputs[0]], {}))
            continue
        fused.append(node)
    nodes = fused

    # consumer map of the fused graph, for the static-int8 requantization
    # chain: a tensor whose ONLY consumer is an int8 conv (possibly through
    # MaxPools — quantization is monotonic, so it commutes with max) is
    # requantized to int8 at its PRODUCER with that conv's calibrated
    # activation scale. XLA fuses the quantize into the producer's epilogue,
    # so the inter-layer activation materializes in HBM as int8 — the
    # bandwidth win int8 exists for (the trunk is HBM-bound,
    # docs/EFFICIENCY.md). Numerically identical to quantizing at the conv
    # input (same scale, max commutes with the monotone quantizer).
    consumer_nodes: Dict[str, List[OnnxNode]] = {}
    for node in nodes:
        for name in node.inputs:
            consumer_nodes.setdefault(name, []).append(node)

    def apply(params: Dict[str, jax.Array], x: jax.Array):
        env: Dict[str, jax.Array] = {graph.input_names[0]: x}
        qenv: Dict[str, jax.Array] = {}   # int8 epilogue-requantized tensors
        conv_absmax: Dict[str, jax.Array] = {}

        def get(name: str) -> jax.Array:
            if name in env:
                return env[name]
            return params[name]

        def requant_key(name: str) -> Optional[str]:
            """ascale param key if `name` flows (only) into an int8 conv with
            a static calibrated scale, else None."""
            if name in output_names:
                return None
            cs = consumer_nodes.get(name, [])
            if len(cs) != 1:
                return None
            c = cs[0]
            if c.op == "Conv" and c.inputs[0] == name:
                k = f"{c.inputs[1]}#ascale"
                if k in params and params[c.inputs[1]].dtype == jnp.int8:
                    return k
                return None
            if c.op == "MaxPool":
                return requant_key(c.outputs[0])
            return None

        for node in nodes:
            if node.op == "Conv":
                w = params[node.inputs[1]]
                b = params.get(node.inputs[2]) if len(node.inputs) > 2 else None
                w_scale = params.get(f"{node.inputs[1]}#scale")
                a_scale = params.get(f"{node.inputs[1]}#ascale")
                xin = get(node.inputs[0])
                if capture_conv_inputs:
                    ax = jnp.abs(xin.astype(jnp.float32))
                    conv_absmax[node.inputs[1]] = (
                        jnp.quantile(ax.reshape(-1), capture_quantile)
                        if capture_quantile is not None else jnp.max(ax))
                x_q = (qenv.get(node.inputs[0])
                       if a_scale is not None else None)
                y = _conv(xin, w, b, node, compute_dtype,
                          w_scale, a_scale, x_q=x_q)
            elif node.op == "Relu":
                y = jnp.maximum(get(node.inputs[0]), 0)
            elif node.op == "Clip":
                lo = node.attr("min", -jnp.inf)
                hi = node.attr("max", jnp.inf)
                y = jnp.clip(get(node.inputs[0]), lo, hi)
            elif node.op == "MaxPool":
                if node.inputs[0] in qenv:
                    # pool the int8 tensor directly; the fp32 view (env) is
                    # dead unless an unexpected consumer appears, and XLA
                    # DCEs it in that case... it cannot: requant_key only
                    # fires on single-consumer tensors, so env's fp32 copy
                    # of this pool is dead by construction (XLA removes it).
                    yq = _maxpool(qenv[node.inputs[0]], node)
                    qenv[node.outputs[0]] = yq
                    k = requant_key(node.outputs[0])
                    y = yq.astype(jnp.float32) * params[k]
                else:
                    y = _maxpool(get(node.inputs[0]), node)
            elif node.op == "BatchNormalization":
                xin = get(node.inputs[0])
                gamma = params[node.inputs[1]]
                beta = params[node.inputs[2]]
                mean = params[node.inputs[3]]
                var = params[node.inputs[4]]
                eps = float(node.attr("epsilon", 1e-5))
                # clamp: variance buffers must never drive rsqrt negative
                scale = gamma * jax.lax.rsqrt(jnp.maximum(var, 0.0) + eps)
                y = xin * scale + (beta - mean * scale)
            elif node.op == "Add":
                y = get(node.inputs[0]) + get(node.inputs[1])
            elif node.op == "Sub":
                y = get(node.inputs[0]) - get(node.inputs[1])
            elif node.op == "Mul":
                y = get(node.inputs[0]) * get(node.inputs[1])
            elif node.op == "Concat":
                axis = int(node.attr("axis", 1))
                if axis == 1:
                    axis = -1  # NCHW channel axis -> NHWC channel axis
                y = jnp.concatenate([get(i) for i in node.inputs], axis=axis)
            elif node.op == "L2Normalize":
                xin = get(node.inputs[0]).astype(jnp.float32)
                y = xin * jax.lax.rsqrt(
                    jnp.sum(xin * xin, axis=-1, keepdims=True) + 1e-12)
            elif node.op == "ReduceL2":
                axes = node.attr("axes", [1])
                axes = tuple(-1 if int(a) == 1 else int(a) for a in axes)
                keep = bool(node.attr("keepdims", 1))
                xin = get(node.inputs[0]).astype(jnp.float32)
                y = jnp.sqrt(jnp.sum(xin * xin, axis=axes, keepdims=keep))
            elif node.op == "Div":
                num = get(node.inputs[0]).astype(jnp.float32)
                den = get(node.inputs[1]).astype(jnp.float32)
                # guard the in-graph descriptor L2 normalisation against
                # all-zero activations (0/0 -> NaN); real weights keep
                # denominators O(1) so this is semantics-preserving
                den = jnp.where(jnp.abs(den) < 1e-12, 1e-12, den)
                y = num / den
            else:
                raise NotImplementedError(f"ONNX op {node.op} not supported")
            env[node.outputs[0]] = y
            if node.op != "MaxPool":
                k = requant_key(node.outputs[0])
                if k is not None:
                    from spsvo.models.quantize import quantize_activation
                    qenv[node.outputs[0]] = quantize_activation(
                        y.astype(jnp.float32), params[k])

        outputs = {name: env[name].astype(jnp.float32)
                   for name in output_names}
        if capture_conv_inputs:
            return outputs, conv_absmax
        return outputs

    return apply


def load_onnx_model(path: str, compute_dtype=jnp.float32):
    """Parse + convert: returns (apply_fn, params_pytree)."""
    graph = parse_onnx(path)
    unsupported = {n.op for n in graph.nodes} - _SUPPORTED_OPS
    if unsupported:
        raise NotImplementedError(f"{path}: unsupported ops {unsupported}")
    params = {k: jnp.asarray(v) for k, v in build_params(graph).items()}
    return make_apply(graph, compute_dtype), params

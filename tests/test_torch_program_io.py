"""The port's program I/O against the JAX package, on the CPU.

``paddle_tpu_torch/proto/framework_wire.py`` writes and reads the proto2
wire format of ``framework.proto`` without protobuf; here it is held
byte for byte against ``framework_pb2`` (this container has protobuf):

- the same ``ProgramDesc`` (the JAX package's programs: an MLP, a tiny
  Transformer for training and ``is_test``, ``resnet_cifar10``; and
  random blocks from hypothesis with every attr type, negative ints,
  ``-1`` dims, empty lists, non-ASCII strings) encodes to the same
  bytes, and each package decodes the other's bytes to the same message;
- ``Program.parse_from_string(jax_bytes).desc_str()`` gives the bytes
  back, the port's own build of each program writes the JAX package's
  bytes, the JAX package parses the port's bytes op for op, and
  ``content_digest`` and ``clone(for_test)`` agree across the packages;
- truncated input raises wherever protobuf raises; a numpy-integer or
  None attr raises TypeError in both; ``Variable.grad_name``, ``ndim``
  and ``astype`` match.

Every comparison is exact: bytes, ints, strings and floats as written.
"""

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import paddle_tpu as pfluid
from paddle_tpu.models import resnet as PR
from paddle_tpu.models import transformer as PT
from paddle_tpu.proto import framework_pb2 as pb

import paddle_tpu_torch as tfluid
from paddle_tpu_torch.models import resnet as TR
from paddle_tpu_torch.models import transformer as TT
from paddle_tpu_torch.proto import framework_wire as wire

_PKG = {"jax": (pfluid, PT, PR), "torch": (tfluid, TT, TR)}
_CFG = dict(src_vocab_size=37, trg_vocab_size=41, max_length=64, d_model=16,
            d_inner=32, n_head=2, n_layer=2, dropout=0.1,
            label_smooth_eps=0.1)


def _mlp(fluid, T, R):
    x = fluid.layers.data("x", shape=[16], dtype="float32")
    h = fluid.layers.fc(x, 32, act="relu")
    return fluid.layers.softmax(fluid.layers.fc(h, 4))


def _transformer_train(fluid, T, R):
    m = T.build(T.TransformerConfig(**_CFG))
    fluid.optimizer.Adam(1e-3).minimize(m["loss"])


def _transformer_test(fluid, T, R):
    T.build(T.TransformerConfig(**_CFG), is_test=True)


def _resnet(fluid, T, R):
    img = fluid.layers.data("data", shape=[3, 32, 32], dtype="float32")
    R.resnet_cifar10(img, class_dim=10, depth=20, is_test=True)


_PROGRAMS = {"mlp": _mlp, "transformer_train": _transformer_train,
             "transformer_test": _transformer_test, "resnet_cifar10": _resnet}


def _build(pkg, name):
    fluid, T, R = _PKG[pkg]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        _PROGRAMS[name](fluid, T, R)
    return main


_JAX_BYTES = {}


def _jax_bytes(name):
    if name not in _JAX_BYTES:
        _JAX_BYTES[name] = _build("jax", name).desc_str()
    return _JAX_BYTES[name]


# --- pb message <-> wire message, field by field -------------------------


def _to_wire(msg, cls):
    out = cls()
    for fd, value in msg.ListFields():
        sub = getattr(cls, "_BY_NAME")[fd.name].kind
        if fd.message_type is not None:
            setattr(out, fd.name, [_to_wire(m, sub) for m in value])
        elif fd.is_repeated:
            setattr(out, fd.name, list(value))
        else:
            setattr(out, fd.name, value)
    return out


def _ops(program):
    return [(op.type, op.inputs, op.outputs, op.attrs)
            for b in program.blocks for op in b.ops]


def _vars(program):
    return [(b.idx, n, v.shape, v.dtype, v.persistable, v.stop_gradient,
             v.is_parameter, v.trainable, v.kind)
            for b in program.blocks for n, v in b.vars.items()]


@pytest.mark.parametrize("name", sorted(_PROGRAMS))
def test_codec_writes_and_reads_the_pb_bytes(name):
    jb = _jax_bytes(name)
    d = pb.ProgramDesc.FromString(jb)
    w = _to_wire(d, wire.ProgramDesc)
    assert w.SerializeToString() == jb
    back = wire.ProgramDesc.FromString(jb)
    assert back == w
    assert back.SerializeToString() == jb


@pytest.mark.parametrize("name", sorted(_PROGRAMS))
def test_port_parses_and_writes_back_the_jax_bytes(name):
    jb = _jax_bytes(name)
    port = tfluid.Program.parse_from_string(jb)
    assert port.desc_str() == jb
    jax_prog = pfluid.Program.parse_from_string(jb)
    assert _ops(port) == _ops(jax_prog)
    assert _vars(port) == _vars(jax_prog)
    assert port.content_digest() == jax_prog.content_digest()


@pytest.mark.parametrize("name", sorted(_PROGRAMS))
def test_port_built_program_writes_the_jax_bytes(name):
    """The port's layers build the JAX package's program: the same ops,
    attrs, vars and version, so the same bytes; the JAX package parses
    them op for op."""
    port = _build("torch", name)
    tb = port.desc_str()
    assert tb == _jax_bytes(name)
    jax_prog = pfluid.Program.parse_from_string(tb)
    assert _ops(jax_prog) == _ops(tfluid.Program.parse_from_string(tb))
    # built, not parsed: a built 0-d var has shape (), a parsed one None,
    # in both packages
    assert port.content_digest() == _build("jax", name).content_digest()


@pytest.mark.parametrize("name", sorted(_PROGRAMS))
def test_clone_for_test_matches_the_jax_clone(name):
    jb = _jax_bytes(name)
    jc = pfluid.Program.parse_from_string(jb).clone(for_test=True)
    tc = tfluid.Program.parse_from_string(jb).clone(for_test=True)
    assert _ops(tc) == _ops(jc)
    assert tc.desc_str() == jc.desc_str()
    # the port's own program, trained state maps included
    src = _build("torch", name)
    own = src.clone(for_test=True)
    assert _ops(own) == _ops(jc)
    assert own._param_grad_map == src._param_grad_map
    assert own._amp == src._amp
    assert own._uid != src._uid


def test_truncated_input_raises_where_protobuf_raises():
    jb = _jax_bytes("mlp")
    raised = 0
    for n in range(0, len(jb), 3):
        try:
            pb.ProgramDesc.FromString(jb[:n])
            pb_ok = True
        except Exception:
            pb_ok = False
        if pb_ok:
            assert wire.ProgramDesc.FromString(jb[:n]).SerializeToString() \
                == pb.ProgramDesc.FromString(jb[:n]).SerializeToString()
        else:
            raised += 1
            with pytest.raises(wire.DecodeError):
                tfluid.Program.parse_from_string(jb[:n])
    assert raised > len(jb) // 6
    for bad in (b"\x0a\xff", b"\x0f\x01", b"\x00\x01",
                b"\x18" + b"\xff" * 11, b"\x0b"):
        with pytest.raises(Exception):
            pb.ProgramDesc.FromString(bad)
        with pytest.raises(wire.DecodeError):
            wire.ProgramDesc.FromString(bad)


def test_unknown_and_packed_fields_read_as_protobuf_reads_them():
    d = pb.ProgramDesc(version=7)
    b = d.blocks.add(idx=0, parent_idx=-1)
    v = b.vars.add(name="v")
    v.shape.extend([-1, 3, 5])
    data = d.SerializeToString()
    # an unknown varint, fixed64, fixed32, bytes field and group on top
    extra = (b"\xa8\x06\x05" + b"\xb1\x06" + b"\x01" * 8 + b"\xbd\x06"
             + b"\x02" * 4 + b"\xc2\x06\x02hi" + b"\xcb\x06\xa8\x06\x01"
             + b"\xcc\x06")
    p = pb.ProgramDesc.FromString(data + extra)
    assert p.version == 7 and list(p.blocks[0].vars[0].shape) == [-1, 3, 5]
    assert wire.ProgramDesc.FromString(data + extra).SerializeToString() \
        == data
    # VarDesc.shape packed: protobuf accepts it, and so does the codec
    packed = wire.VarDesc(name="p")
    body = b"\x0a\x01p" + b"\x22\x0c" + b"\xff" * 9 + b"\x01\x03\x05"
    packed.ParseFromString(body)
    assert packed.shape == list(pb.VarDesc.FromString(body).shape) \
        == [-1, 3, 5]


def test_encoder_refuses_what_protobuf_refuses():
    with pytest.raises(wire.EncodeError):
        wire.BlockDesc(idx=0).SerializeToString()
    with pytest.raises(wire.EncodeError):
        wire.BlockDesc(idx=1 << 31, parent_idx=0).SerializeToString()


@pytest.mark.parametrize("value", [np.int64(3), np.int32(-1), None,
                                   [1, "a"], {"k": 1}, np.bool_(True)])
def test_unsupported_attr_raises_type_error_in_both(value):
    for fluid in (pfluid, tfluid):
        prog = fluid.Program()
        prog.global_block().append_op("mean", attrs={"bad": value})
        with pytest.raises(TypeError):
            prog.desc_str()


def test_variable_accessors_match_the_jax_package():
    progs = []
    for fluid in (pfluid, tfluid):
        main = fluid.Program()
        with fluid.program_guard(main, fluid.Program()), \
                fluid.unique_name.guard():
            x = fluid.layers.data("x", shape=[4, 3], dtype="float32")
            y = x.astype("float64")
            progs.append((x, y, main))
    (jx, jy, jm), (tx, ty, tm) = progs
    assert tx.grad_name == "x@GRAD"
    assert (tx.grad_name, tx.ndim, ty.ndim, ty.dtype, ty.shape) == \
        (jx.grad_name, jx.ndim, jy.ndim, jy.dtype, jy.shape)
    unshaped = tfluid.Program().global_block().create_var(name="u",
                                                          shape=None)
    assert unshaped.ndim is None
    assert tm.desc_str() == jm.desc_str()
    op = tm.global_block().ops[-1]
    assert op.input("X") == ["x"] and op.output("Out") == [ty.name]
    assert op.attr("out_dtype") == "float64" and op.attr("nope", 5) == 5
    op._set_attr("out_dtype", "float32")
    assert op.attrs["out_dtype"] == "float32"


# --- random blocks with every attr type ----------------------------------

_text = st.text(st.characters(codec="utf-8", exclude_categories=("Cs",)),
                max_size=6)
_i32 = st.integers(-(1 << 31), (1 << 31) - 1)
_i64 = st.integers(-(1 << 63), (1 << 63) - 1)
_f32 = st.floats(width=32, allow_nan=False)
_f64 = st.floats(allow_nan=False)
_ATTR_VALUES = {
    pb.INT: ("i", _i32), pb.FLOAT: ("f", _f32), pb.STRING: ("s", _text),
    pb.INTS: ("ints", st.lists(_i32, max_size=4)),
    pb.FLOATS: ("floats", st.lists(_f32, max_size=4)),
    pb.STRINGS: ("strings", st.lists(_text, max_size=3)),
    pb.BOOLEAN: ("b", st.booleans()),
    pb.BOOLEANS: ("bools", st.lists(st.booleans(), max_size=4)),
    pb.BLOCK: ("block_idx", _i32),
    pb.LONG: ("l", _i64), pb.BLOCKS: ("blocks_idx", st.lists(_i32,
                                                             max_size=3)),
    pb.LONGS: ("longs", st.lists(_i64, max_size=4)),
    pb.FLOAT64: ("float64", _f64),
}


@st.composite
def _attr(draw):
    t = draw(st.sampled_from(sorted(_ATTR_VALUES)))
    field, values = _ATTR_VALUES[t]
    return draw(_text), t, field, draw(values)


_var = st.tuples(_text, st.none() | st.integers(0, 4), st.none() | _text,
                 st.lists(st.integers(-1, 1 << 40), max_size=4),
                 *[st.none() | st.booleans()] * 4)
_slots = st.lists(st.tuples(_text, st.lists(_text, max_size=3)), max_size=2)
_op = st.tuples(_text, _slots, _slots, st.lists(_attr(), max_size=5))
_block = st.tuples(_i32, _i32, st.lists(_var, max_size=3),
                   st.lists(_op, max_size=3))
_program = st.tuples(st.lists(_block, max_size=3), st.none() | _i64,
                     st.none() | _i64)


def _fill(msg, lib):
    """The same description into a pb or a wire ProgramDesc."""
    blocks, version, seed = msg
    d = lib.ProgramDesc()
    if version is not None:
        d.version = version
    if seed is not None:
        d.random_seed = seed
    for idx, parent, vars_, ops in blocks:
        bd = lib.BlockDesc(idx=idx, parent_idx=parent)
        for name, kind, dtype, shape, *flags in vars_:
            vd = lib.VarDesc(name=name)
            if kind is not None:
                vd.kind = kind
            if dtype is not None:
                vd.dtype = dtype
            vd.shape.extend(shape)
            for field, f in zip(("persistable", "stop_gradient",
                                 "is_parameter", "trainable"), flags):
                if f is not None:
                    setattr(vd, field, f)
            bd.vars.append(vd)
        for type_, ins, outs, attrs in ops:
            od = lib.OpDesc(type=type_)
            for dst, slots in ((od.inputs, ins), (od.outputs, outs)):
                for slot, args in slots:
                    v = lib.OpDesc.Var(parameter=slot)
                    v.arguments.extend(args)
                    dst.append(v)
            for name, t, field, value in attrs:
                a = lib.OpDesc.Attr(name=name, type=t)
                if isinstance(value, list):
                    getattr(a, field).extend(value)
                else:
                    setattr(a, field, value)
                od.attrs.append(a)
            bd.ops.append(od)
        d.blocks.append(bd)
    return d


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_program)
def test_random_programs_encode_and_decode_as_protobuf(desc):
    want = _fill(desc, pb).SerializeToString()
    got = _fill(desc, wire).SerializeToString()
    assert got == want
    back = wire.ProgramDesc.FromString(want)
    assert back.SerializeToString() == want
    assert pb.ProgramDesc.FromString(got) == pb.ProgramDesc.FromString(want)

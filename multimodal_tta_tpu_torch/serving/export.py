"""Serving artifacts: the serving step as one file that a runtime replays
with no model code (the port of ``multimodal_tta_tpu/serving/export.py``).

The step is traced with ``make_fx`` on the device it will serve on (the
trace runs the step once), handed to ``torch.export.export`` and written with
``torch.export.save``. The program holds aten operators and the port's two
registered kernel operators (``mtta::fused_instance_norm_forward`` /
``_backward``, ``kernels/``), so replaying it launches the same CUDA kernels
as the live step; nothing is compiled to new code (no AOTInductor), and the
runtime needs ``torch`` and ``kernels/`` but no ``models/``, ``conf/`` or
``core/``.

Two artifact modes, as in the reference:

- **forward** (``export_forward_serving``): ``probs = call(image)``, the
  model's parameters baked into the program as constants.
- **adapt** (``export_adapt_serving``): an adapter's pure adapt+segment
  step (``TentAdapter.serving_export_spec``) over flat arguments::

      (*state, image, *draws, n_valid, ent_floor) -> (*state', entropies [steps], pred uint8)

  ``state`` is every param of the model, its running statistics, the
  optimizer's state and the method's carry (``tta/tent.py`` gives the
  order; ``meta["args"]`` names each leaf). The runtime threads it batch to
  batch (continual) or feeds the initial state again (episodic; the step
  also starts its optimizer afresh). The initial state ships in the file.
  ``draws`` are the step's random numbers, made on the host by
  ``ServingArtifact.draws(generator, n_valid)`` from the spec that the meta
  records (``ops/augment.py``): the port's counterpart of the reference's
  ``rng`` argument, as the port draws from a ``torch.Generator``.

File layout (one file)::

    magic "MTTAPT01" | u32 header_len | header JSON (utf-8)
    | u64 prog_len | torch.export.save bytes
    | u64 state_len | npz of the initial state (adapt mode; 0 otherwise)

The magic differs from the JAX package's ("MTTASRV1"), so each package's
loader refuses the other's file. An artifact is traced on, and records, one
device: loading or calling it on another raises (the reference lowers one
file for several platforms instead).
"""

from __future__ import annotations

import io
import json
import struct
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.fx.experimental.proxy_tensor import make_fx

from .. import DeviceLike, kernels, resolve_device  # noqa: F401  (kernels: registers the operators)
from ..ops.augment import make_draws

MAGIC = b"MTTAPT01"
FORMAT_VERSION = 1


def _arg_meta(name: str, t: torch.Tensor) -> dict:
    """Name, shape, dtype and strides of one flat argument (a conv kernel
    of the model is ``channels_last_3d``, as its activations)."""
    return {"name": name, "shape": list(t.shape), "dtype": str(t.dtype).replace("torch.", ""),
            "stride": list(t.stride())}


def _trace(fn: Callable, args: Sequence[torch.Tensor]) -> torch.export.ExportedProgram:
    """``fn`` over flat tensors as an exported program: ``make_fx`` on the
    real arguments (the trace runs ``fn`` once, so the program holds the
    strides the device gave), then ``torch.export.export``.

    Export derives every tensor's strides again with its own shape
    propagation, which lays a convolution's output out contiguous where the
    device gives ``channels_last_3d``. So each ``view`` that the trace took
    on the device's strides becomes a ``reshape``, which export resolves
    with its own (a copy where it cannot view; none of these views is
    written in place)."""
    gm = make_fx(fn)(*args)
    view, reshape = torch.ops.aten.view.default, torch.ops.aten.reshape.default
    for node in gm.graph.nodes:
        if node.target is view:
            if any(u.target._schema.is_mutable for u in node.users if isinstance(u.target, torch._ops.OpOverload)):
                raise AssertionError(f"serving export: {node} is written in place")
            node.target = reshape
    gm.recompile()
    program = torch.export.export(gm, tuple(args))
    program.example_inputs = None  # not saved with the program: the state ships once, as the npz
    return program


# ---------------------------------------------------------------------------
# exporters
# ---------------------------------------------------------------------------
def export_forward_serving(
    probs_fn: Callable[[torch.Tensor], torch.Tensor],
    image_shape: Sequence[int],
    image_dtype: torch.dtype = torch.float32,
    *,
    device: DeviceLike = "cuda",
) -> Tuple[torch.export.ExportedProgram, dict]:
    """Export ``probs_fn(image) -> probabilities`` (its params baked in).

    ``probs_fn`` is any closure over the trained model, e.g.
    ``lambda img: strategy._probs_fn(model)(img)[1]``, so normalization and
    flip-TTA folded into it are exported too."""
    dev = resolve_device(device)
    image = torch.zeros(tuple(int(s) for s in image_shape), dtype=image_dtype, device=dev)

    def fn(x):
        return probs_fn(x)

    with torch.no_grad():
        program = _trace(fn, [image])
    meta = {
        "format_version": FORMAT_VERSION,
        "mode": "forward",
        "device": str(dev),
        "n_state": 0,
        "args": [_arg_meta("image", image)],
        "torch_version": torch.__version__,
    }
    return program, meta


def export_adapt_serving(
    adapter,
    source_model: torch.nn.Module,
    image_shape: Sequence[int],
    image_dtype: torch.dtype = torch.float32,
    *,
    threshold: float,
    predict_mode: Optional[str] = None,
    device: DeviceLike = "cuda",
) -> Tuple[torch.export.ExportedProgram, dict, List[torch.Tensor]]:
    """Export the adapt+segment step of a ``TentAdapter`` (or a method on
    it) for ``source_model``. Returns ``(program, meta, initial state)``;
    the outputs are the state in the same order, the entropy trace
    ``[steps]`` and the uint8 predictions."""
    if getattr(adapter, "fisher_enabled", False):
        raise ValueError(
            "[serving] EATA's Fisher anchor accumulates its weights host-side "
            "across batches (tta/tent.py:_maybe_accumulate_fisher) — that "
            "stateful estimation cannot live inside a pure exported program. "
            "Export with tta.fisher.enabled=false (the gate and all in-step "
            "defenses export fine)."
        )
    if not hasattr(adapter, "serving_export_spec"):
        raise ValueError(
            f"[serving] {type(adapter).__name__} does not implement the "
            "serving_export_spec protocol (tent/cotta/sar/eata do)"
        )
    dev = resolve_device(device)
    if adapter.device != dev:
        raise ValueError(f"[serving] the adapter runs on {adapter.device}, the artifact on {dev}")
    mode = str(predict_mode or adapter.predict_mode).lower()
    call, state0, names = adapter.serving_export_spec(source_model, float(threshold), mode)
    shape = tuple(int(s) for s in image_shape)
    draw_spec = adapter.batch_draw_spec(shape, adapter.serving_post(mode))
    gen = torch.Generator(device=dev).manual_seed(0)
    image = torch.randn(shape, generator=gen, device=dev).to(image_dtype)
    draws = make_draws(draw_spec, gen, shape[0])
    n_valid = torch.tensor(shape[0], dtype=torch.int32, device=dev)
    floor = torch.tensor(float("nan"), dtype=torch.float32, device=dev)
    n_state, n_draws = len(state0), len(draws)

    def fn(*args):
        state, image, draws = args[:n_state], args[n_state], args[n_state + 1:n_state + 1 + n_draws]
        new, ents, pred = call(state, image, draws, args[-2], args[-1])
        return (*new, ents, pred)

    args = [*state0, image, *draws, n_valid, floor]
    program = _trace(fn, args)
    arg_names = [*names, "image", *(f"draw_{i}" for i in range(n_draws)), "n_valid", "ent_floor"]
    meta = {
        "format_version": FORMAT_VERSION,
        "mode": "adapt",
        "device": str(dev),
        "method": adapter.method,
        "n_state": n_state,
        "predict_mode": mode,
        "threshold": float(threshold),
        "steps": int(adapter.steps),
        "episodic": bool(adapter.episodic),
        "draws": draw_spec,
        "args": [_arg_meta(n, t) for n, t in zip(arg_names, args)],
        "outputs": "state (n_state) + entropies[steps] + pred uint8",
        "torch_version": torch.__version__,
    }
    return program, meta, [t.detach() for t in state0]


# ---------------------------------------------------------------------------
# artifact file IO
# ---------------------------------------------------------------------------
def save_artifact(path: str, program: torch.export.ExportedProgram, meta: dict,
                  state: Optional[Sequence[torch.Tensor]] = None) -> None:
    buf = io.BytesIO()
    torch.export.save(program, buf)
    prog = buf.getvalue()
    state_blob = b""
    if state:
        sbuf = io.BytesIO()
        np.savez(sbuf, **{f"leaf_{i:06d}": t.detach().cpu().numpy() for i, t in enumerate(state)})
        state_blob = sbuf.getvalue()
    header = json.dumps(meta, sort_keys=True).encode("utf-8")
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        f.write(struct.pack("<Q", len(prog)))
        f.write(prog)
        f.write(struct.pack("<Q", len(state_blob)))
        f.write(state_blob)


class ServingArtifact:
    """A loaded artifact: ``call(*flat)`` plus its metadata, on one device.

    An adapt-mode artifact's serving loop::

        art = load_artifact(path)
        state = art.initial_state()
        gen = torch.Generator(device=art.device).manual_seed(seed)
        for image in stream:
            out = art.call(*state, image, *art.draws(gen, n_valid), n_valid, float("nan"))
            state, ents, pred = out[:art.n_state], out[art.n_state], out[art.n_state + 1]

    (episodic serving passes ``art.initial_state()`` every time). Python
    numbers for ``n_valid`` and ``ent_floor`` become tensors of the recorded
    type; every tensor must lie on the artifact's device."""

    def __init__(self, program: torch.export.ExportedProgram, meta: dict, state_blob: bytes,
                 device: DeviceLike):
        self.meta = meta
        self.device = resolve_device(device)
        self._state_blob = state_blob
        self._dtypes = [self._dtype(a) for a in meta["args"]]
        self._shapes = [tuple(a["shape"]) for a in meta["args"]]
        self._scalars = {}
        # the program's graph over flat inputs, called directly: its lifted
        # constants first (restore sources, ...), then the arguments; the
        # checks of ``program.module()`` are the shape and device checks of
        # ``call`` here
        sig = program.graph_signature
        user = torch.export.graph_signature.InputKind.USER_INPUT
        lifted = {**program.state_dict, **program.constants}
        self._lifted = [lifted[s.target] for s in sig.input_specs if s.kind != user]
        if [s.kind for s in sig.input_specs] != [s.kind for s in sig.input_specs if s.kind != user] + [user] * len(
                self._dtypes):
            raise ValueError("[serving] the program's inputs are not its constants, then the arguments")
        if any(s.kind != torch.export.graph_signature.OutputKind.USER_OUTPUT for s in sig.output_specs):
            raise ValueError("[serving] the program writes its inputs; a serving step returns its state")
        self._graph = program.graph_module

    @staticmethod
    def _dtype(arg: dict) -> torch.dtype:
        return getattr(torch, arg["dtype"])

    @property
    def n_state(self) -> int:
        return int(self.meta.get("n_state", 0))

    def initial_state(self) -> List[torch.Tensor]:
        """The initial state on the device, with the strides it was traced with."""
        if not self._state_blob:
            return []
        out = []
        with np.load(io.BytesIO(self._state_blob)) as z:
            for k, a in zip(sorted(z.files), self.meta["args"]):
                t = torch.empty_strided(a["shape"], a["stride"], dtype=self._dtype(a), device=self.device)
                out.append(t.copy_(torch.from_numpy(z[k])))
        return out

    def draws(self, generator: torch.Generator, n_valid: int) -> List[torch.Tensor]:
        """One batch's random numbers from ``generator`` (on the artifact's
        device), as the step takes them; none for a stock Tent config."""
        if self.meta["mode"] != "adapt":
            return []
        return make_draws(self.meta["draws"], generator, int(n_valid))

    def call(self, *args):
        if len(args) != len(self._dtypes):
            raise ValueError(f"[serving] the artifact takes {len(self._dtypes)} arguments, got {len(args)}")
        flat = list(self._lifted)
        for i, (a, dtype, shape) in enumerate(zip(args, self._dtypes, self._shapes)):
            if not isinstance(a, torch.Tensor):
                # one device tensor per value, made once: no copy to the card per call
                key = (i, repr(a))  # NaN != NaN: key by its text
                if key not in self._scalars:
                    self._scalars[key] = torch.tensor(a, dtype=dtype, device=self.device)
                a = self._scalars[key]
            elif a.device != self.device:
                raise ValueError(f"[serving] the artifact runs on {self.device}; got a tensor on {a.device}")
            if a.shape != shape or a.dtype != dtype:
                raise ValueError(f"[serving] argument {self.meta['args'][i]['name']} must be {dtype} {list(shape)}, "
                                 f"got {a.dtype} {list(a.shape)}")
            flat.append(a)
        with torch.no_grad():
            out = self._graph(*flat)
        out = tuple(out) if isinstance(out, (tuple, list)) else (out,)
        return out[0] if self.meta["mode"] == "forward" else out


def load_artifact(path: str, device: DeviceLike = "cuda") -> ServingArtifact:
    """Read an artifact for ``device``, which must be the one it was traced on."""
    dev = resolve_device(device)
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic != MAGIC:
            raise ValueError(f"[serving] {path}: not a serving artifact (magic {magic!r})")
        (hlen,) = struct.unpack("<I", f.read(4))
        meta = json.loads(f.read(hlen).decode("utf-8"))
        if meta["device"] != str(dev):
            raise ValueError(f"[serving] {path} was traced on {meta['device']}; it cannot run on {dev}")
        (plen,) = struct.unpack("<Q", f.read(8))
        prog = f.read(plen)
        (slen,) = struct.unpack("<Q", f.read(8))
        state_blob = f.read(slen) if slen else b""
    program = torch.export.load(io.BytesIO(prog))
    return ServingArtifact(program, meta, state_blob, dev)

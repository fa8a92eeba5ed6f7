"""Serving artifacts: export once with `torch.export`, serve without model code.

Counterpart of `pytorch_glow_tpu/serve.py`.  `export_artifact` traces each
serving entry point of a model once, with its parameters baked into the
exported program, and writes one `torch.export` program per function
beside a `manifest.json`.  A serving process then needs only torch and the
kernels' op registrations (`ops/library.py`): no model code, no profile,
no checkpoint.

Artifact layout (one directory):

    manifest.json   format version, torch version, batch, shapes, device,
                    the config, and per function its file, arguments,
                    bytes and the seconds its export and save took
    <name>.pt2      `torch.export.save` of one entry point

Each program holds its own copy of the weights (`package_pt2`'s archive
writes each program's state dict apart too, so one archive would not hold
them once); the manifest records every file's bytes.

Entry points (B is the export batch, or a symbolic dimension "b" with
batch_size="dynamic", where one artifact serves any batch):

    sample(temperature f32[], eps...)            -> uint8 images
    sample_y(temperature, labels i64[B], eps...) -> uint8 images  (y-cond)
    encode(x u8[B,H,W,C])                        -> z_L f32
    decode(z f32, temperature, eps...)           -> uint8 images
    reconstruct(x u8)                            -> uint8 images (exact z path)
    nll(x u8)                                    -> f32[B] bits/dim
    nll_elbo(x u8, u f32[B,H,W,C])               -> f32[B] (the 1-draw bound)
    nll_y(x u8, labels i64[B])                   -> f32[B]         (y-cond)

The random inputs (`eps`: standard normal draws, `Glow.noise_shapes`; `u`:
the U[0, 1) dequantization draw) are not in the graph: a seed inside an
exported function would be frozen into a constant.  The manifest lists
them with their shapes, and `ServedModel` draws them from
`torch.Generator(device).manual_seed(seed)` in the order the live model
draws them, so a served call gives the live call's bits for that seed.  A
y-conditional model's default functions are the ones with labels (and
encode, decode, reconstruct): its prior needs them.

The default export is the portable unfused path (`flowstep_impl="xla"`,
`invconv_impl="xla"`), as the JAX package's `keep_kernels=False` is.
`keep_kernels=True` exports the config's kernels (the fused flow step K1 /
K2, K4 on bands, the LU 1x1 conv K6a / K6b) as their `torch.library` ops;
on a CUDA model that gives a CUDA-only artifact that launches the
hand-written kernels.  Either way a graph is specialised to the device it
was exported on (the unfused bf16 zero conv takes one route on the card and
another on the CPU, `models/layers._ConvF32Sum`), so the manifest's
"device" is a requirement: a CUDA artifact is refused on a host without a
card, and a kernel artifact whose kernels cannot be built is refused when
it is loaded.  Nothing falls back.

An exported graph does not carry PyTorch's global flags, so every served
call runs with f32 convs and products pinned to true f32 (`ops/math.
true_f32`) and cuDNN pinned to deterministic algorithms, as the live model
pins its f32 ops.

SPMD serving (`mesh=`, the JAX package's pod serving): a mesh with a
"data" axis, given as {axis name: size}.  The
manifest records it ("mesh": {"shape", "axis_names"}) and per function
the argument specs ("arg_specs": ["data"] for a batch argument, [] for a
scalar, which is replicated); each program is exported at the batch of
one data coordinate, batch_size / data.  `ServedModel` then runs on a
`torch.distributed` group of exactly the mesh's device count (the ranks
form the mesh, row-major): each rank runs the program on its data
coordinate's rows of every batch argument and the outputs are
all-gathered over the data axis, so every rank returns the whole batch.
Random draws are made from the seed for the whole batch and
sliced, so a sharded call gives the one-device artifact's draws.  A CUDA
program runs on the device index it was exported on (the graph holds
it), so ranks on several cards each see their own card as cuda:0
(`CUDA_VISIBLE_DEVICES`, as `scripts/bench_serve.py`'s SPMD mode sets it).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from pytorch_glow_tpu_torch.ops import library  # noqa: F401  (registers the kernels' ops)
from pytorch_glow_tpu_torch.ops.math import true_f32
from pytorch_glow_tpu_torch.parallel import distributed as pd

FORMAT_VERSION = 1
MANIFEST = "manifest.json"
BASE_FUNCTIONS = ("sample", "encode", "decode", "reconstruct", "nll", "nll_elbo")
LABEL_FUNCTIONS = ("sample_y", "nll_y")
# The functions a y-conditional model cannot serve without labels.
_UNLABELLED = ("sample", "nll", "nll_elbo")


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------


class _Entry(nn.Module):
    """One serving entry point over the model, for `torch.export`."""

    def __init__(self, model, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def _onehot(model, labels: torch.Tensor) -> torch.Tensor:
    classes = torch.arange(model.cfg.y_classes, device=labels.device)
    return (labels[:, None] == classes).float()


def _sample(m, temperature, *eps):
    return m.postprocess(m.sample(eps[0].shape[0], temperature, noise=list(eps)))


def _sample_y(m, temperature, labels, *eps):
    return m.postprocess(m.sample(eps[0].shape[0], temperature, y_onehot=_onehot(m, labels),
                                  noise=list(eps)))


def _encode(m, x):
    return m.encode(m.preprocess(x))[0]


def _decode(m, z, temperature, *eps):
    return m.postprocess(m.decode(z, temperature=temperature, noise=list(eps)))


def _reconstruct(m, x):
    return m.postprocess(m.reconstruct(m.preprocess(x)))


def _nll(m, x):
    return m.log_prob(m.preprocess(x))["nll"]


def _nll_elbo(m, x, u):
    return m.nll_bound(m.preprocess(x), None, 1, "elbo", noise=[u])


def _nll_y(m, x, labels):
    return m.log_prob(m.preprocess(x), y_onehot=_onehot(m, labels))["nll"]


_FNS = {"sample": _sample, "sample_y": _sample_y, "encode": _encode, "decode": _decode,
        "reconstruct": _reconstruct, "nll": _nll, "nll_elbo": _nll_elbo, "nll_y": _nll_y}


def _arg_specs(model, name: str) -> list[dict]:
    """The entry point's arguments in order: {"name", "shape" (with "b" for
    the batch), "dtype", "kind"}; kind "input" comes from the caller,
    "normal" / "uniform" is a random draw the loader makes."""
    cfg = model.cfg
    image = ["b", *cfg.image_shape]
    eps = [{"name": f"eps{i}", "shape": ["b", *s[1:]], "dtype": "float32", "kind": "normal"}
           for i, s in enumerate(model.noise_shapes(1))]
    temperature = {"name": "temperature", "shape": [], "dtype": "float32", "kind": "input"}
    x = {"name": "x", "shape": image, "dtype": "uint8", "kind": "input"}
    labels = {"name": "labels", "shape": ["b"], "dtype": "int64", "kind": "input"}
    return {
        "sample": [temperature, *eps],
        "sample_y": [temperature, labels, *eps],
        "encode": [x],
        "decode": [{"name": "z", "shape": ["b", *cfg.final_latent_shape], "dtype": "float32",
                    "kind": "input"}, temperature, *eps[1:]],
        "reconstruct": [x],
        "nll": [x],
        "nll_elbo": [x, {"name": "u", "shape": image, "dtype": "float32", "kind": "uniform"}],
        "nll_y": [x, labels],
    }[name]


def _example(spec: dict, batch: int, device: torch.device) -> torch.Tensor:
    shape = [batch if d == "b" else d for d in spec["shape"]]
    dtype = getattr(torch, spec["dtype"])
    if spec["name"] == "temperature":
        return torch.tensor(0.7, device=device)
    if dtype == torch.float32:
        return torch.rand(shape, generator=torch.Generator().manual_seed(0)).to(device)
    return torch.zeros(shape, dtype=dtype, device=device)


def export_artifact(model, cfg=None, out_dir: str = "artifact", batch_size: int | str = 16,
                    functions: tuple[str, ...] | None = None,
                    keep_kernels: bool = False, mesh=None) -> dict:
    """Export serving entry points of `model` (its parameters as they are)
    to `out_dir`; returns the manifest.

    cfg: the model's config (default `model.cfg`).  batch_size: a fixed
    serving batch, or "dynamic" for a symbolic batch dimension (not with a
    mesh).  functions: a subset of the entry points (default: all the
    model serves).  keep_kernels: export the config's hand-written kernels
    as their ops instead of the portable unfused path.  mesh: {axis name:
    size} with a "data" axis, for SPMD serving (module docstring)."""
    from pytorch_glow_tpu_torch.models.glow import Glow

    cfg = cfg or model.cfg
    if not keep_kernels:
        cfg = dataclasses.replace(cfg, flowstep_impl="xla", invconv_impl="xla")
    available = [*BASE_FUNCTIONS, *(LABEL_FUNCTIONS if cfg.y_condition else ())]
    if functions is None:
        functions = tuple(f for f in available if not (cfg.y_condition and f in _UNLABELLED))
    unknown = sorted(set(functions) - set(available))
    if unknown:
        raise ValueError(f"unknown serving functions {unknown}; available: {sorted(available)}")
    if cfg.y_condition and set(functions) & set(_UNLABELLED):
        raise ValueError(f"{sorted(set(functions) & set(_UNLABELLED))} need labels on a "
                         f"y-conditional model: serve sample_y / nll_y")
    if batch_size != "dynamic" and (not isinstance(batch_size, int) or batch_size < 1):
        raise ValueError(f"batch_size must be a positive int or 'dynamic', got {batch_size!r}")
    axes = None if mesh is None else {str(k): int(v) for k, v in mesh.items()}
    if axes is not None:
        if batch_size == "dynamic":
            raise ValueError("batch_size='dynamic' is incompatible with mesh export (each data "
                             "coordinate's program needs a concrete batch)")
        if "data" not in axes:
            raise ValueError(f"mesh {list(axes)} has no 'data' axis")
        if batch_size % axes["data"]:
            raise ValueError(f"batch_size {batch_size} must divide over the data axis of size "
                             f"{axes['data']}")
    device = model.device
    if model.cfg != cfg:
        state = model.state_dict()
        model = Glow(cfg).to(device)
        model.load_state_dict(state)
    model.eval()

    os.makedirs(out_dir, exist_ok=True)
    manifest: dict = {
        "format_version": FORMAT_VERSION,
        "torch_version": torch.__version__,
        "batch_size": batch_size,
        "image_shape": list(cfg.image_shape),
        "final_latent_shape": list(cfg.final_latent_shape),
        "y_condition": cfg.y_condition,
        "device": device.type,
        "keep_kernels": keep_kernels,
        "glow_config": dataclasses.asdict(cfg),
        "mesh": None if axes is None else {"shape": list(axes.values()),
                                           "axis_names": list(axes)},
        "functions": {},
    }
    dynamic = batch_size == "dynamic"
    example_batch = 2 if dynamic else batch_size // (axes or {}).get("data", 1)
    for name in functions:
        specs = _arg_specs(model, name)
        args = tuple(_example(s, example_batch, device) for s in specs)
        shapes = None
        if dynamic:  # the entry point's varargs, each batched argument's dim 0
            b = torch.export.Dim("b", min=1)
            shapes = (tuple({0: b} if "b" in s["shape"] else None for s in specs),)
        t0 = time.perf_counter()
        with torch.no_grad():
            program = torch.export.export(_Entry(model, _FNS[name]), args, dynamic_shapes=shapes)
        t1 = time.perf_counter()
        path = os.path.join(out_dir, f"{name}.pt2")
        torch.export.save(program, path)
        seconds = {"export": t1 - t0, "save": time.perf_counter() - t1}
        if not dynamic:
            specs = [{**s, "shape": [batch_size if d == "b" else d for d in s["shape"]]}
                     for s in specs]
        manifest["functions"][name] = {"file": f"{name}.pt2", "args": specs,
                                       "bytes": os.path.getsize(path), "seconds": seconds}
        if axes is not None:  # batch arguments over "data", scalars replicated
            manifest["functions"][name]["arg_specs"] = [["data"] if s["shape"] else []
                                                        for s in specs]
    manifest = json.loads(json.dumps(manifest))  # tuples -> lists, as loaded
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


# ---------------------------------------------------------------------------
# Load / serve (model-code free: torch and the kernels' ops)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _pinned():
    """True f32 for f32 convs and products, and deterministic cuDNN, for
    the block; the flags are restored after."""
    cudnn = torch.backends.cudnn
    saved = (cudnn.deterministic, cudnn.benchmark)
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        with true_f32():
            yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


class ServedModel:
    """Callable view of an artifact directory.  Programs load at first use
    and stay cached; inputs move to the artifact's device and results stay
    there."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, MANIFEST)) as f:
            self.manifest = json.load(f)
        version = self.manifest["format_version"]
        if version > FORMAT_VERSION:
            raise ValueError(f"artifact format {version} is newer than this loader "
                             f"({FORMAT_VERSION})")
        self.batch_size = self.manifest["batch_size"]
        self.device = torch.device(self.manifest["device"])
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"artifact {path} was exported for cuda; this host has no "
                                   f"CUDA device")
            if self.manifest["keep_kernels"]:
                from pytorch_glow_tpu_torch.ops import _build

                _build.library()  # raises where the kernels cannot be built
        self._fns: dict = {}
        self._shard = self._join_mesh(self.manifest.get("mesh"))

    def _join_mesh(self, mesh: dict | None):
        """(data coordinate, data axis size, data group) of this rank on an
        SPMD artifact's mesh; None without one.  Collective: every rank of
        the group constructs its ServedModel."""
        if mesh is None:
            return None
        shape, names = mesh["shape"], mesh["axis_names"]
        n = int(np.prod(shape))
        world = pd.world_size()
        if world != n:
            raise ValueError(f"artifact was exported for a {shape} mesh ({n} devices); this "
                             f"process group has {world}: serve it on exactly {n} ranks")
        axis = names.index("data")
        rank = dist.get_rank() if dist.is_initialized() else 0
        mine, group = None, None
        others = [i for i in range(len(shape)) if i != axis]
        for fixed in np.ndindex(*[shape[i] for i in others]):  # one data group each
            ranks = []
            for d in range(shape[axis]):
                coord = list(fixed)
                coord.insert(axis, d)
                ranks.append(int(np.ravel_multi_index(coord, shape)))
            g = dist.new_group(ranks) if world > 1 else None
            if rank in ranks:
                mine, group = ranks.index(rank), g
        return mine, shape[axis], group

    @property
    def functions(self) -> list[str]:
        return sorted(self.manifest["functions"])

    def fn(self, name: str):
        """The loaded program of one entry point (its `.module()`)."""
        if name not in self._fns:
            meta = self.manifest["functions"].get(name)
            if meta is None:
                raise KeyError(f"artifact has no function {name!r} (has: {self.functions})")
            program = torch.export.load(os.path.join(self.path, meta["file"]))
            self._fns[name] = program.module()
        return self._fns[name]

    def call(self, name: str, inputs: dict, batch: int, seed: int = 0):
        """Run entry point `name` on `inputs` (by argument name), drawing its
        random arguments from a generator seeded `seed`, in order; on an
        SPMD artifact's mesh each data coordinate runs its rows and the
        outputs are gathered (module docstring)."""
        fn = self.fn(name)
        args = self._args(name, inputs, batch, seed)
        if self._shard is None:
            return self._run(fn, args)
        coord, data, group = self._shard
        batched = [bool(spec) for spec in self.manifest["functions"][name]["arg_specs"]]
        per = batch // data
        rows = [a[coord * per:(coord + 1) * per] if b else a for a, b in zip(args, batched)]
        out = self._run(fn, rows)
        return out if group is None else pd.all_gather_cat(out, 0, group)

    @staticmethod
    def _run(fn, args):
        with torch.no_grad(), _pinned():
            return fn(*args)

    def _args(self, name: str, inputs: dict, batch: int, seed: int) -> list[torch.Tensor]:
        gen = None
        args = []
        for spec in self.manifest["functions"][name]["args"]:
            dtype = getattr(torch, spec["dtype"])
            if spec["kind"] == "input" and not spec["shape"]:
                # A scalar is filled on the device: a copy from pageable
                # host memory would wait for the device's queue.
                args.append(torch.full((), float(inputs[spec["name"]]), dtype=dtype,
                                       device=self.device))
                continue
            if spec["kind"] == "input":
                args.append(torch.as_tensor(inputs[spec["name"]]).to(self.device, dtype))
                continue
            if gen is None:
                gen = torch.Generator(device=self.device).manual_seed(seed)
            shape = [batch if d == "b" else d for d in spec["shape"]]
            draw = torch.randn if spec["kind"] == "normal" else torch.rand
            args.append(draw(shape, generator=gen, dtype=dtype, device=self.device))
        return args

    def _batch(self, n: int | None) -> int:
        if self.batch_size != "dynamic":
            return self.batch_size
        return 16 if n is None else n

    # -- convenience wrappers ------------------------------------------------

    def sample(self, seed: int = 0, temperature: float = 0.7, labels=None,
               n: int | None = None) -> torch.Tensor:
        """uint8 samples; n: the batch of a "dynamic" artifact (a fixed one
        gives its exported batch)."""
        t = float(temperature)
        if labels is not None:
            labels = torch.as_tensor(labels)
            return self.call("sample_y", {"temperature": t, "labels": labels},
                             labels.shape[0], seed)
        return self.call("sample", {"temperature": t}, self._batch(n), seed)

    def encode(self, images) -> torch.Tensor:
        x = torch.as_tensor(images)
        return self.call("encode", {"x": x}, x.shape[0])

    def decode(self, z, seed: int = 0, temperature: float = 0.0) -> torch.Tensor:
        z = torch.as_tensor(z)
        return self.call("decode", {"z": z, "temperature": float(temperature)}, z.shape[0], seed)

    def reconstruct(self, images) -> torch.Tensor:
        x = torch.as_tensor(images)
        return self.call("reconstruct", {"x": x}, x.shape[0])

    def nll(self, images, labels=None) -> torch.Tensor:
        x = torch.as_tensor(images)
        if labels is not None:
            return self.call("nll_y", {"x": x, "labels": torch.as_tensor(labels)}, x.shape[0])
        return self.call("nll", {"x": x}, x.shape[0])

    def nll_elbo(self, images, seed: int = 0) -> torch.Tensor:
        """The single-draw bound on the discrete NLL (the published protocol)."""
        x = torch.as_tensor(images)
        return self.call("nll_elbo", {"x": x}, x.shape[0], seed)


def load_artifact(path: str) -> ServedModel:
    return ServedModel(path)

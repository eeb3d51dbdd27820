"""Kernel policy (port of ``schemanet_tpu/ops/policy.py``): which fields of
the model run a hand-written kernel and which run its plain version.

The fields, their choices, the ``SCHEMANET_*`` variables and their
precedence are the JAX package's, so one YAML ``kernels:`` mapping serves
both packages: an environment variable overrides the configured value,
which overrides ``auto``. ``configure`` (the config's ``kernels:``, or
``--set kernels.<field>=...``) rejects an unknown key with ``KeyError`` and
an unknown value with ``ValueError``, as in JAX.

The values read on the card:

* ``pallas``, ``pallas2`` and ``fused`` take the field's hand kernel;
* ``xla``, ``interpret`` and ``interpret2`` take its plain PyTorch version
  (the JAX package's interpret mode is how a TPU kernel runs off the chip;
  here the plain version is what stands in for the kernel);
* ``static_embed_bwd``'s ``blocked`` and ``sorted_scatter`` name the JAX
  package's two plain fp32 sums of the class lookup's backward; either takes
  the plain version here (``embed_grad_reference``: fixed-order fp32 sums);
  its ``auto`` is the ``embed_grad`` kernel with the atlas's plan;
* ``symconv`` picks the plain GraphConv's form (``single``: E_sym
  materialised; ``two``: two products), read where ``graphconv`` is plain;
* ``prng_impl: rbg`` (XLA's RngBitGenerator) and ``attn_pack: pair`` (two
  heads packed into one 128-deep MXU product) have no counterpart on the
  card and raise ``ValueError``; every other value of those two fields is
  accepted and changes nothing.

``auto`` keeps the port's measured route: on a CUDA tensor every field with
a hand kernel takes it, on a CPU tensor the wrapper runs its plain version,
as every kernel wrapper does. The JAX package's TPU winners (``ln``,
``vq``, ``atlas_opt`` and ``embed_bwd`` on XLA) are TPU measurements and
are not carried over.

The routes are resolved once (``routes``), when ``configure`` runs (the
CLI's setup and every worker call it before building a model) or at the
first read, and every site reads that snapshot: no launch reads the
environment. ``configure``, ``set_policy`` and ``reset_policy`` resolve
anew.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Optional

_ENV = {
    "attn": "SCHEMANET_ATTN_BACKEND",
    "block": "SCHEMANET_BLOCK_BACKEND",
    "ln": "SCHEMANET_LN_BACKEND",
    "mlp": "SCHEMANET_MLP_BACKEND",
    "gnn_ln": "SCHEMANET_GNN_LN_BACKEND",
    "graphconv": "SCHEMANET_GRAPHCONV_BACKEND",
    "vq": "SCHEMANET_VQ_BACKEND",
    "symconv": "SCHEMANET_SYMCONV",
    "static_embed_bwd": "SCHEMANET_STATIC_EMBED_BWD",
    "embed_bwd": "SCHEMANET_EMBED_BWD",
    "prng_impl": "SCHEMANET_PRNG_IMPL",
    "atlas_opt": "SCHEMANET_ATLAS_OPT",
    "attn_pack": "SCHEMANET_ATTN_PACK",
}

_CHOICES = {
    "attn": ("auto", "pallas", "interpret", "xla"),
    "block": ("auto", "pallas", "interpret", "xla"),
    "ln": ("auto", "pallas", "interpret", "xla"),
    "mlp": ("auto", "pallas", "interpret", "xla"),
    "gnn_ln": ("auto", "pallas", "interpret", "xla"),
    "graphconv": ("auto", "pallas", "interpret", "xla"),
    "vq": ("auto", "pallas", "xla"),
    "symconv": ("auto", "single", "two"),
    "static_embed_bwd": ("auto", "blocked", "sorted_scatter"),
    "embed_bwd": ("auto", "pallas", "pallas2", "interpret", "interpret2", "xla"),
    "prng_impl": ("auto", "threefry", "rbg"),
    "atlas_opt": ("auto", "fused", "interpret", "xla"),
    "attn_pack": ("auto", "pair", "off"),
}

# "auto" on the card: every hand kernel (a CPU tensor takes the wrapper's
# plain version); static_embed_bwd's choices name two plain sums and no
# kernel, so its auto stays "auto", the embed_grad kernel
_AUTO = {
    "attn": "pallas", "block": "pallas", "ln": "pallas", "mlp": "pallas", "gnn_ln": "pallas",
    "graphconv": "pallas", "vq": "pallas", "symconv": "single", "static_embed_bwd": "auto",
    "embed_bwd": "pallas", "prng_impl": "threefry", "atlas_opt": "fused", "attn_pack": "off",
}

# the values that take a field's plain version
_PLAIN = {"static_embed_bwd": ("blocked", "sorted_scatter")}
_PLAIN_DEFAULT = ("xla", "interpret", "interpret2")

_NO_COUNTERPART = {
    ("prng_impl", "rbg"): "XLA's RngBitGenerator has no counterpart on the GPU: the port draws "
                          "its dropout from PyTorch generators and counter-hashed masks",
    ("attn_pack", "pair"): "the pair packing fills the TPU MXU's 128-deep products with two "
                           "heads of 64; the GPU's tensor-core kernels take each head alone",
}

# the fields whose hand kernel a plain value replaces, in the JAX order
KERNEL_FIELDS = ("attn", "block", "ln", "mlp", "gnn_ln", "graphconv", "vq", "static_embed_bwd",
                 "embed_bwd", "atlas_opt")


@dataclasses.dataclass
class KernelPolicy:
    attn: str = "auto"
    block: str = "auto"
    ln: str = "auto"
    mlp: str = "auto"
    gnn_ln: str = "auto"
    graphconv: str = "auto"
    vq: str = "auto"
    symconv: str = "auto"
    static_embed_bwd: str = "auto"
    embed_bwd: str = "auto"
    prng_impl: str = "auto"
    atlas_opt: str = "auto"
    attn_pack: str = "auto"


@dataclasses.dataclass(frozen=True)
class Routes:
    """The resolved policy as the sites read it: True where a field takes
    its hand kernel; ``symconv`` the plain GraphConv's form."""

    attn: bool = True
    block: bool = True
    ln: bool = True
    mlp: bool = True
    gnn_ln: bool = True
    graphconv: bool = True
    vq: bool = True
    static_embed_bwd: bool = True
    embed_bwd: bool = True
    atlas_opt: bool = True
    symconv: str = "single"


_policy = KernelPolicy()
_routes: Optional[Routes] = None


def _check(field: str, value: str, origin: str) -> None:
    if value not in _CHOICES[field]:
        raise ValueError(f"{origin}={value!r} invalid (choose from {_CHOICES[field]})")
    if (field, value) in _NO_COUNTERPART:
        raise ValueError(f"{origin}={value!r} is not supported on the GPU: "
                         f"{_NO_COUNTERPART[field, value]}")


def get_policy() -> KernelPolicy:
    return _policy


def configure(kernels: Optional[Mapping[str, str]]) -> None:
    """Apply a config-file ``kernels:`` mapping (unknown keys rejected),
    then resolve the routes anew (the environment read here)."""
    for k, v in (kernels or {}).items():
        if k not in _ENV:
            raise KeyError(f"unknown kernels.{k} (choose from {sorted(_ENV)})")
        _check(k, v, f"kernels.{k}")
        setattr(_policy, k, v)
    refresh()


def set_policy(**kw: str) -> None:
    configure(kw)


def reset_policy() -> None:
    global _policy
    _policy = KernelPolicy()
    refresh()


def resolve(field: str) -> str:
    """env override > configured policy > the port's ``auto``."""
    env = os.environ.get(_ENV[field])
    if env:
        _check(field, env, _ENV[field])
    value = env or getattr(_policy, field)
    return _AUTO[field] if value == "auto" else value


def uses_kernel(field: str) -> bool:
    """True where ``field`` resolves to its hand kernel."""
    return resolve(field) not in _PLAIN.get(field, _PLAIN_DEFAULT)


def refresh() -> Routes:
    """Resolve every field now and keep the snapshot the sites read."""
    global _routes
    for field in ("prng_impl", "attn_pack"):  # accepted or rejected, nothing to route
        resolve(field)
    _routes = Routes(**{f: uses_kernel(f) for f in KERNEL_FIELDS}, symconv=resolve("symconv"))
    return _routes


def routes() -> Routes:
    """The resolved routes (resolved at the first read if no ``configure``
    came before)."""
    return _routes if _routes is not None else refresh()


def resolved() -> dict:
    """Every field's resolved value, as a run prints it."""
    return {f: resolve(f) for f in _ENV}

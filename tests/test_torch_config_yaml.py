"""The port's YAML reader (``schemanet_torch/utils/config.py``) against the
JAX package's PyYAML route, on the CPU: each shipped config read with PyYAML
hidden from the port equals ``schemanet_tpu.utils.config.get_cfg``'s dict;
the override strings of the stage scripts, the parity kit and the accuracy
gates are typed as the JAX ``parse_override_strings`` types them, and
``apply_overrides`` gives the same configs; plain scalars are typed as
``yaml.safe_load`` types them (hypothesis); every construct outside the
subset raises ``ValueError`` naming its line."""

import math
import pathlib
import sys

import pytest
import yaml
from hypothesis import assume, given, settings
from hypothesis import strategies as st

from schemanet_torch.utils import config as torch_config
from schemanet_tpu.utils import config as jax_config

REPO = pathlib.Path(__file__).resolve().parents[1]
CONFIGS = sorted(str(p.relative_to(REPO)) for p in (REPO / "configs").rglob("*.yaml"))


def test_thirty_shipped_configs():
    assert len(CONFIGS) == 30


@pytest.mark.parametrize("path", CONFIGS)
def test_shipped_config_without_pyyaml(path, monkeypatch):
    want = jax_config.get_cfg(str(REPO / path))
    monkeypatch.setitem(sys.modules, "yaml", None)  # any import of PyYAML now raises
    assert torch_config.get_cfg(str(REPO / path)) == want


# the -o overrides of scripts/torch/*.sh, tools/parity_run_torch.sh and the
# two gate scripts, as the shell passes them (unquoted values)
SCRIPT_OVERRIDES = [
    "dataset.num_classes=100", "training.train_epochs=3", "training.val_interval=100000",
    "training.batch_size=256", "discretization.vocabulary.size=1024",
    "schema_net.bundle=run/ab_gp_torch/ingredient/bundle",
    "schema_net.initial_state_fp=run/ab_gp_torch/init_IR_atlas.pt",
    "schema_net.ir_atlas.graph_precision=default", "schema_net.ir_atlas.graph_precision=highest",
    "training.param_groups.0.cfg.moment_dtype=bfloat16",
    "training.param_groups.0.cfg.nu_dtype=bfloat16",
    "training.param_groups.0.cfg.nu_factored_min_size=64",
    "training.batch_size=8", "validation.batch_size=8", "dataset.num_samples=256",
    "training.num_workers=1", "validation.num_workers=1", "dataset.image_size=32",
    "dataset.resize=32", "model.patch_embed.img_size=32", "training.lr_schedule.eta_min=1e-3",
    "training.optimizer.lr=1.0e-3", "kernels.graphconv=xla", "training.dtype=float32",
    "schema_net.ir_atlas.class_max_vertices=null", "training.drop_remain=yes",
    "discretization.vocabulary.uniform_range=[0, 1]", "loss.name='ce_loss'",
    "training.print_interval=", "model.pre_train=",
]


def test_script_overrides_typed_as_jax():
    got = torch_config.parse_override_strings(SCRIPT_OVERRIDES)
    want = jax_config.parse_override_strings(SCRIPT_OVERRIDES)
    assert got == want
    for pair in SCRIPT_OVERRIDES:  # one at a time: a later key replaces an earlier one
        key = pair.partition("=")[0]
        g, w = (m.parse_override_strings([pair])[key] for m in (torch_config, jax_config))
        assert g == w and type(g) is type(w), pair
    one = torch_config.parse_override_strings
    assert one(["a=bfloat16"])["a"] == "bfloat16" and one(["a=default"])["a"] == "default"
    assert one(["a=3"])["a"] == 3 and one(["a=[0, 1]"])["a"] == [0, 1]
    assert one(["a=1e-3"])["a"] == "1e-3" and one(["a=1.0e-3"])["a"] == 1e-3


GATE_ARMS = {
    "stage0": ["dataset.num_classes=100", "training.train_epochs=3",
               "training.val_interval=100000", "training.batch_size=256"],
    "stage1": ["dataset.num_classes=100", "discretization.vocabulary.size=1024"],
    "default": ["dataset.num_classes=100", "schema_net.bundle=run/x/ingredient/bundle",
                "schema_net.initial_state_fp=run/x/init_IR_atlas.pt",
                "schema_net.ir_atlas.graph_precision=default", "training.train_epochs=3"],
    "factored": ["dataset.num_classes=100", "training.param_groups.0.cfg.moment_dtype=bfloat16",
                 "training.param_groups.0.cfg.nu_dtype=bfloat16",
                 "training.param_groups.0.cfg.nu_factored_min_size=64"],
    "dry": ["training.train_epochs=1", "training.batch_size=8", "validation.batch_size=8",
            "dataset.num_samples=256", "training.num_workers=1", "validation.num_workers=1"],
}
SYNTHETIC = {"stage0": "configs/synthetic/vanilla/deit_tiny.yaml",
             "stage1": "configs/synthetic/ingredient/deit_tiny-l9-M_128.yaml",
             "default": "configs/synthetic/schema_net/deit_tiny-l9-M_128.yaml",
             "factored": "configs/synthetic/schema_net/deit_tiny-l9-M_128.yaml",
             "dry": "configs/synthetic/schema_net/deit_tiny-l9-M_128.yaml"}


@pytest.mark.parametrize("arm", sorted(GATE_ARMS))
def test_apply_overrides_on_synthetic_configs(arm, monkeypatch):
    """Through the ``dataset:`` file reference and into list indices."""
    path, base = str(REPO / SYNTHETIC[arm]), str(REPO / pathlib.Path(SYNTHETIC[arm]).parent)
    want = jax_config.apply_overrides(jax_config.get_cfg(path),
                                      jax_config.parse_override_strings(GATE_ARMS[arm]), base)
    monkeypatch.chdir(REPO)  # the configs name their dataset file from the repository's root
    monkeypatch.setitem(sys.modules, "yaml", None)
    got = torch_config.apply_overrides(torch_config.get_cfg(path),
                                       torch_config.parse_override_strings(GATE_ARMS[arm]), base)
    assert got == want
    if "dataset.num_classes=100" in GATE_ARMS[arm]:
        assert got["dataset"]["num_classes"] == 100 and got["dataset"]["name"] == "synthetic"


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a) and math.isnan(b):
        return True
    return a == b and type(a) is type(b)


SCALAR_WORDS = ["yes", "No", "TRUE", "off", "On", "null", "Null", "~", "NULL", ".inf", "-.Inf",
                ".NaN", "0b101", "0x1F", "0o17", "017", "08", "1_000", "1:30", "1:20.5",
                "1e-3", "1.0e-05", "1.e5", "+.5", "-0", "2001-12-14", "<<", "="]


@settings(max_examples=400, deadline=None, derandomize=True)
@given(st.one_of(
    st.sampled_from(SCALAR_WORDS),
    st.text(alphabet="0123456789+-._:eExb ", min_size=1, max_size=12),
    st.text(alphabet="yesnotrufalNYTFOL~ab", min_size=1, max_size=6),
    st.floats(allow_nan=False, allow_subnormal=False).map(repr), st.integers().map(str),
))
def test_plain_scalars_typed_as_safe_load(text):
    """Equal to ``yaml.safe_load`` where it reads a value of the subset,
    else a ``ValueError`` (timestamps, merge and value keys, malformed
    input)."""
    assume(not text.lstrip(" ").startswith(("---", "...")))
    try:
        want = yaml.safe_load(text)
    except (yaml.YAMLError, ValueError):
        with pytest.raises(ValueError):
            torch_config.load_yaml(text)
        return
    if not isinstance(want, (bool, int, float, str, list, dict, type(None))):
        with pytest.raises(ValueError):  # a timestamp
            torch_config.load_yaml(text)
        return
    got = torch_config.load_yaml(text)
    if isinstance(want, (list, dict)):
        assert got == want or repr(got) == repr(want), (text, got, want)
    else:
        assert _same(got, want), (text, got, want)


@pytest.mark.parametrize("text, line, what", [
    ("a: 1\nb: &anchor 2\n", 2, "anchors"),
    ("a: 1\nb: *alias\n", 2, "aliases"),
    ("a: !!str 1\n", 1, "tags"),
    ("a: 1\n\nb: |\n  text\n", 3, "block scalars"),
    ("a: >\n  text\n", 1, "block scalars"),
    ("a:\n  b: {c: 1}\n", 2, "flow mappings"),
    ("a: 1\n---\nb: 2\n", 2, "several documents"),
    ("a: 2001-12-14\n", 1, "timestamps"),
    ("a: plain\n  continued\n", 2, "continued on the next line"),
    ("a: [1, 2\n", 1, "must close on its line"),
    ("a: 'open\n", 1, "must close on its line"),
    ("a:\n\tb: 1\n", 2, "tabs"),
    ("? a\n", 1, "complex mapping keys"),
    ("a: 1\n  b: 2\n", 2, "unexpected indentation"),
    ("a: b: c\n", 1, "mapping value"),
    ("a: \"x\\q\"\n", 1, "escape"),
])
def test_unsupported_constructs_name_their_line(tmp_path, text, line, what):
    path = tmp_path / "cfg.yaml"
    path.write_text(text)
    with pytest.raises(ValueError, match=f"cfg.yaml, line {line}: .*{what}"):
        torch_config.get_cfg(str(path))

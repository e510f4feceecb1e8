"""The port's config against the JAX package's.

`prepare_cfg(...).to_dict()` equal to JAX's on single- and multi-subject
path conventions (every resolver, the bracket indirection); the port's
JSON base config equal to `yaml.safe_load` of the JAX package's YAML; the
YAML value reader (`config/yaml_values.py`) equal to `yaml.safe_load` on a
table of values, PyYAML's YAML 1.1 readings included, and refusing what it
does not read; a user's YAML config read through PyYAML, and a clear error
where PyYAML is missing. All comparisons are exact.
"""

import datetime
import json
import math
import os
import sys

import pytest
import yaml

from moshpp_tpu.config import config as jax_config

from moshpp_torch.config import config
from moshpp_torch.config.yaml_values import parse_value

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_json_base_equals_yaml():
    with open(os.path.join(REPO, "moshpp_tpu", "config",
                           "moshpp_conf.yaml")) as f:
        ref = yaml.safe_load(f)
    with open(os.path.join(REPO, "moshpp_torch", "config",
                           "moshpp_conf.json")) as f:
        assert json.load(f) == ref


def _write_capture(path, labels):
    import numpy as np
    from moshpp_torch.io.mocap import write_mocap_c3d
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.default_rng(0)
    write_mocap_c3d(rng.normal(size=(4, len(labels), 3)), labels, path)


@pytest.fixture()
def captures(tmp_path):
    single = str(tmp_path / "mocap" / "MyDS" / "Session 1" / "walk 01.c3d")
    _write_capture(single, ["A", "B"])
    with open(os.path.join(os.path.dirname(single), "settings.json"), "w") as f:
        json.dump({"gender": "female"}, f)
    multi = str(tmp_path / "mocap" / "DuoDS" / "S2" / "dance.c3d")
    _write_capture(multi, ["Ann:A", "Ann:B", "Bob:A", "Bob:B"])
    with open(os.path.join(os.path.dirname(multi), "settings.json"), "w") as f:
        json.dump({"Ann": {"gender": "female"}, "Bob": {"gender": "male"}}, f)
    return single, multi, str(tmp_path / "work")


@pytest.mark.parametrize("case", ["single", "single_perseq", "multi_ann",
                                  "multi_bob", "dict_and_bracket",
                                  "missing_file"])
def test_prepare_cfg_matches_jax(captures, case):
    single, multi, work = captures
    base = {"dirs.work_base_dir": work, "dirs.support_base_dir": "/support"}
    dict_cfg = None
    if case == "single":
        kw = {"mocap.fname": single}
    elif case == "single_perseq":
        kw = {"mocap.fname": single, "moshpp.perseq_mosh_stagei": True,
              "surface_model.type": "smplh"}
    elif case.startswith("multi"):
        # the subject named: the JAX package cannot resolve it from
        # `mocap.subject_id` (test_subject_id_resolves)
        kw = {"mocap.fname": multi, "mocap.multi_subject": True,
              "mocap.subject_name": "Ann" if case == "multi_ann" else "Bob"}
    elif case == "dict_and_bracket":
        kw = {"mocap.fname": single, "surface_model.type": "mano",
              "opt_settings.weights_type": "smplh",
              "opt_settings.weights":
                  "${opt_weights[${opt_settings.weights_type}]}"}
        dict_cfg = {"surface_model": {"type": "smplh"},
                    "opt_settings.maxiter": 7}
    else:
        kw = {"mocap.fname": "/nowhere/DS/S/x.c3d",
              "surface_model.gender": "neutral"}
    kw.update(base)
    mine = config.prepare_cfg(dict_cfg=dict_cfg, **kw)
    ref = jax_config.prepare_cfg(dict_cfg=dict_cfg, **kw)
    assert mine.to_dict() == ref.to_dict()
    assert mine.to_dict(resolve=False) == ref.to_dict(resolve=False)
    for key in ("dirs.stagei_fname", "dirs.stageii_fname",
                "dirs.marker_layout.fname", "surface_model.gender",
                "mocap.subject_name", "mocap.multi_subject",
                "moshpp.stagei_frame_picker.stagei_mocap_fnames"):
        assert mine[key] == ref[key], key


@pytest.mark.parametrize("sid,name,gender", [(0, "Ann", "female"),
                                              (1, "Bob", "male")])
def test_subject_id_resolves(captures, sid, name, gender):
    """`mocap.subject_id` picks the subject of a multi-subject capture. The
    JAX package raises here: its resolver arguments split the interpolated
    subject list "['Ann', 'Bob']" at its comma; the port's respect its
    brackets. Otherwise the config is the one JAX gives with the subject
    named."""
    _, multi, work = captures
    base = {"mocap.fname": multi, "dirs.work_base_dir": work,
            "dirs.support_base_dir": "/support"}
    with pytest.raises(TypeError):
        jax_config.prepare_cfg(**base, **{"mocap.subject_id": sid})[
            "mocap.subject_name"]
    mine = config.prepare_cfg(**base, **{"mocap.subject_id": sid})
    assert mine["mocap.subject_name"] == name
    assert mine["mocap.multi_subject"] is True
    assert mine["surface_model.gender"] == gender
    assert mine["dirs.stageii_fname"] == os.path.join(
        work, "DuoDS", "S2", name, "dance_stageii.pkl")
    ref = jax_config.prepare_cfg(**base, **{
        "mocap.multi_subject": True, "mocap.subject_name": name}).to_dict()
    ref["mocap"]["subject_id"] = sid
    assert mine.to_dict() == ref


# values as `-o key=value` gives them, and as interpolation leaves them
YAML_TABLE = [
    # PyYAML's YAML 1.1 floats: a dot is needed, an exponent needs its sign
    "1e-3", "1.0e-3", "1.5e3", "1.5e+3", ".5", "5.", "-.inf", ".NaN", "+1.0",
    "1_0.5", "1:30.5", "0.01",
    # booleans
    "yes", "Yes", "YES", "no", "NO", "on", "On", "ON", "off", "true", "False",
    "TRUE", "y", "n",
    # ints: hex, octal, binary, underscores, sexagesimal
    "0x10", "0X10", "1_000", "010", "08", "0b101", "-0x1f", "+5", "-0", "0",
    "1:30", "190:20:30", "50", "-7",
    # nulls
    "~", "null", "Null", "NULL", "", "  ", "None", "none",
    # flow sequences and mappings
    "[a, b]", "[]", "[1, 2.0, yes, ~]", "[a, [b, c], 'd e', \"f\\tg\"]",
    "[a, b,]", "[/data/DS/S1/walk.c3d]", "[C:/x]", "[ a , b ]", "[1,2]",
    "[a:b]", "{a: 1, b: [x, y]}", "{}", "{a}", "{a: }", "{a:b}",
    # quoted scalars
    "'quoted'", "'it''s'", "\"dq \\u00e9\\x41\"", "'1.0'", "\"yes\"",
    # strings, comments, timestamps
    "smplx", "surface model", "a,b", "a]b", "a # comment", "# only",
    "5 # five", "a#b", "/path/to/file.c3d", "C:/data", "http://x.org/a",
    "a:b", "--x", "-1.5", "2001-12-14", "2001-12-14t21:59:43.10-05:00",
    "2001-12-14 21:59:43.10",
]


@pytest.mark.parametrize("text", YAML_TABLE)
def test_parse_value_matches_safe_load(text):
    ref = yaml.safe_load(text)
    got = parse_value(text)
    assert type(got) is type(ref)
    if isinstance(ref, float) and math.isnan(ref):
        assert math.isnan(got)
    else:
        assert got == ref
    if isinstance(ref, (datetime.date, datetime.datetime)):
        assert repr(got) == repr(ref)


# YAML it does not read (block collections, anchors, aliases, tags, block
# scalars, a mapping in a sequence) and text that is not YAML at all
@pytest.mark.parametrize("text", ["a: b", "- x", "- 1", "-", "&a x", "*a",
                                  "!tag x", "|", "=", "<<", "[a: b]",
                                  "[a, , b]", "'a' b", "[a] b", "[a, b",
                                  "'open", "a\nb"])
def test_parse_value_refuses(text):
    with pytest.raises(ValueError):
        parse_value(text)


def test_coerce_matches_jax():
    for s in ("null", "None", "~", "", "true", "False", "12", "1e-3", "0.5",
              "[a, b]", "[x, [1, 2]]", "[unclosed, ]", "[a, , b]", "plain",
              "${not.resolved}", 5, None):
        assert config._coerce(s) == jax_config._coerce(s), s


def test_user_yaml_config(tmp_path, monkeypatch):
    fname = str(tmp_path / "mine.yaml")
    with open(os.path.join(REPO, "moshpp_tpu", "config",
                           "moshpp_conf.yaml")) as f:
        text = f.read()
    with open(fname, "w") as f:
        f.write(text.replace("maxiter: 100", "maxiter: 33"))
    cfg = config.load_config(fname)
    assert cfg["opt_settings.maxiter"] == 33
    kw = {"mocap.fname": "/a/DS/S/x.c3d", "surface_model.gender": "male",
          "dirs.work_base_dir": "/w", "dirs.support_base_dir": "/s"}
    assert (config.prepare_cfg(base_config=fname, **kw).to_dict()
            == jax_config.prepare_cfg(base_yaml=fname, **kw).to_dict())
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        config.load_config(fname)
    assert config.load_config()["opt_settings.maxiter"] == 100

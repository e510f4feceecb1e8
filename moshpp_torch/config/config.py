"""Config system: the base config + ${...} interpolation + resolvers +
dotlist overrides (port of `moshpp_tpu/config/config.py`).

Drop-in equivalent of the reference's OmegaConf usage (`mosh_head.py:543-559`,
`tools/run_tools.py:125-183`) without the omegaconf dependency: the base config
is merged with dotlist-style keyword overrides and a dict override; values
may reference other keys (`${a.b}`) or call resolvers
(`${resolve_mocap_ds_name:${mocap.fname}}`) that derive dataset/session/
subject/gender from the mocap path convention `.../ds_name/session/base.c3d`
and the sidecar `settings.json` gender file.

The base config is `moshpp_conf.json`, this package's copy of the JAX
package's `moshpp_conf.yaml` (tests/test_torch_config.py holds the two
equal): the machine with the card has no PyYAML. Scalars and flow lists
written in YAML are read by `yaml_values.parse_value`; PyYAML is imported
only to read a config file the caller names that is not JSON.
"""

from __future__ import annotations

import copy
import json
import os
import re
from typing import Callable, Dict, Optional

from moshpp_torch.config.yaml_values import parse_value

_INTERP = re.compile(r"\$\{([^${}]+)\}")

_RESOLVERS: Dict[str, Callable] = {}


def register_resolver(name: str, fn: Callable) -> None:
    _RESOLVERS[name] = fn


def _coerce(s: str):
    if not isinstance(s, str):
        return s
    low = s.strip()
    if low in ("null", "None", "~", ""):
        return None
    if low in ("true", "True"):
        return True
    if low in ("false", "False"):
        return False
    try:
        return int(low)
    except ValueError:
        pass
    try:
        return float(low)
    except ValueError:
        pass
    if low.startswith("[") and low.endswith("]"):
        try:
            return parse_value(low)
        except ValueError:
            return s
    return s


class Config:
    """Nested dict with attribute access and lazy `${...}` resolution."""

    def __init__(self, data: dict, root: Optional["Config"] = None):
        object.__setattr__(self, "_data", data)
        object.__setattr__(self, "_root", root if root is not None else self)

    # -- access ---------------------------------------------------------------
    def __getattr__(self, key: str):
        if key.startswith("_"):
            raise AttributeError(key)
        return self[key]

    def __setattr__(self, key: str, value):
        self._data[key] = value

    def __getitem__(self, key: str):
        if "." in key or "[" in key:
            node = self
            for part in key.split("."):
                for sub in _bracket_segments(part):
                    node = (Config.__getitem__(node, sub)
                            if isinstance(node, Config) else node[sub])
            return node
        val = self._data[key]
        return self._resolve_value(val)

    def __setitem__(self, key: str, value):
        if "." in key:
            parts = key.split(".")
            node = self._data
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = value
        else:
            self._data[key] = value

    def __contains__(self, key: str):
        try:
            self[key]
            return True
        except KeyError:
            return False

    def get(self, key: str, default=None):
        try:
            v = self[key]
            return default if v is None else v
        except KeyError:
            return default

    def keys(self):
        return self._data.keys()

    def items(self):
        return ((k, self[k]) for k in self._data)

    # -- resolution -------------------------------------------------------------
    def _resolve_value(self, val, depth: int = 0):
        if depth > 32:
            raise RecursionError("config interpolation cycle")
        if isinstance(val, dict):
            return Config(val, root=self._root)
        if isinstance(val, list):
            return [self._resolve_value(v, depth + 1) for v in val]
        if not isinstance(val, str):
            return val

        def resolve_expr(expr: str):
            expr = expr.strip()
            if ":" in expr and expr.split(":", 1)[0] in _RESOLVERS:
                name, argstr = expr.split(":", 1)
                args = [self._root._resolve_value(a.strip(), depth + 1)
                        for a in _split_args(argstr)]
                return _RESOLVERS[name](*[_coerce(a) if isinstance(a, str) else a
                                          for a in args])
            # key reference, with OmegaConf-style bracket indirection
            # (`opt_weights[smplh].stagei_wt_poseB` — the inner `${...}` of
            # `${opt_weights[${opt_settings.weights_type}]}` has already been
            # substituted by the outer loop)
            return self._root[expr]

        # full-string interpolation keeps native type
        m = _INTERP.fullmatch(val.strip())
        if m:
            return self._resolve_value(resolve_expr(m.group(1)), depth + 1)

        def repl(match):
            out = self._resolve_value(resolve_expr(match.group(1)), depth + 1)
            return "" if out is None else str(out)

        prev = None
        out = val
        while prev != out and _INTERP.search(out):
            prev = out
            # inner substitutions may reduce a nested expression to one
            # full-string interpolation — return its native value
            m = _INTERP.fullmatch(out.strip())
            if m:
                return self._resolve_value(resolve_expr(m.group(1)), depth + 1)
            out = _INTERP.sub(repl, out)
        if out == "???":
            raise KeyError(f"missing mandatory config value: {val}")
        return _coerce(out) if out != val else out

    def to_dict(self, resolve: bool = True) -> dict:
        if not resolve:
            return copy.deepcopy(self._data)

        def walk(node):
            if isinstance(node, Config):
                return {k: walk(node[k]) for k in node.keys()}
            if isinstance(node, list):
                return [walk(v) for v in node]
            return node

        return walk(self)


def _bracket_segments(part: str):
    """'name[a][b]' -> ['name', 'a', 'b']; plain names pass through."""
    if "[" not in part:
        return [part]
    m = re.fullmatch(r"([^\[\]]+)((\[[^\[\]]+\])*)", part)
    if m is None:
        raise KeyError(f"bad config reference segment: {part!r}")
    return [m.group(1)] + [s.strip() for s in
                           re.findall(r"\[([^\[\]]+)\]", m.group(2))]


def _split_args(argstr: str):
    """Split resolver args on top-level commas (respecting ${...} nesting,
    and the brackets and quotes of an interpolated list such as a
    `resolve_mocap_subjects` result, "['Ann', 'Bob']")."""
    args, depth, quote, cur = [], 0, None, ""
    for ch in argstr:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch in "{[":
            depth += 1
        elif ch in "}]":
            depth -= 1
        if ch == "," and depth == 0 and not quote:
            args.append(cur)
            cur = ""
        else:
            cur += ch
    if cur.strip() or args:
        args.append(cur)
    return args


def _merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _dotlist_to_dict(kwargs: dict) -> dict:
    out: dict = {}
    for k, v in kwargs.items():
        if isinstance(v, dict):
            v = _dotlist_to_dict(v)
        node = out
        parts = k.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


# ---------------------------------------------------------------------------
# resolvers (path-convention metadata, run_tools.py:125-183)
# ---------------------------------------------------------------------------

def _rm_spaces(s: str) -> str:
    return s.replace(" ", "") if isinstance(s, str) else s


def resolve_mosh_subject_gender(mocap_fname, fall_back_gender="error",
                                subject_name=None, multi_subject=False):
    """Gender from the sidecar settings.json next to the mocap
    ({"gender": g} or {subject: {"gender": g}} for multi-subject)."""
    gender_fname = os.path.join(os.path.dirname(str(mocap_fname)), "settings.json")
    data = {}
    if os.path.exists(gender_fname):
        with open(gender_fname) as f:
            data = json.load(f)
    if multi_subject or (subject_name not in (None, "null")):
        gender = data.get(subject_name, {}).get("gender")
    else:
        gender = data.get("gender")
    if gender is None:
        if fall_back_gender == "error":
            raise FileNotFoundError(
                f"gender for subject {subject_name!r} not found in {gender_fname}")
        return fall_back_gender
    return gender


def setup_mosh_resolvers() -> None:
    def subjects(mocap_fname):
        if not os.path.exists(str(mocap_fname)):
            return ["null"]  # single-subject default when unreadable
        from moshpp_torch.io.mocap import MocapSession
        return MocapSession(mocap_fname, "mm").subject_names

    register_resolver("ifelse", lambda cond, a, b: a if cond else b)
    register_resolver("isequal", lambda a, b: a == b)
    register_resolver("isin", lambda a, b: a in b)
    register_resolver("resolve_mocap_ds_name",
                      lambda f: _rm_spaces(str(f).split("/")[-3]))
    register_resolver("resolve_mocap_session",
                      lambda f: _rm_spaces(str(f).split("/")[-2]))
    register_resolver("resolve_mocap_basename",
                      lambda f: _rm_spaces(".".join(str(f).split("/")[-1].split(".")[:-1])))
    register_resolver("resolve_mocap_subjects", subjects)
    register_resolver("resolve_subject_name",
                      lambda names, sid: names[sid] if (sid is not None and sid >= 0) else None)
    register_resolver("resolve_multi_subject",
                      lambda names, sid: bool(names is not None and len(names) > 1
                                              and sid is not None and sid >= 0))
    register_resolver("resolve_gender", resolve_mosh_subject_gender)


_BASE_JSON = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "moshpp_conf.json")


def read_config_file(fname: Optional[str] = None) -> dict:
    """The base config (`moshpp_conf.json`) or a config file the caller
    names: JSON, or else YAML through PyYAML, imported only here."""
    fname = fname or _BASE_JSON
    with open(fname) as f:
        if fname.endswith(".json"):
            return json.load(f)
        try:
            import yaml
        except ImportError as e:
            raise ImportError(
                f"reading the YAML config {fname} needs PyYAML, which is not "
                "installed; give the config as JSON instead") from e
        return yaml.safe_load(f)


def load_config(config_fname: Optional[str] = None) -> Config:
    setup_mosh_resolvers()
    return Config(read_config_file(config_fname))


def prepare_cfg(dict_cfg: Optional[dict] = None,
                base_config: Optional[str] = None, **kwargs) -> Config:
    """Base config <- dotlist kwargs <- dict override (MoSh.prepare_cfg,
    mosh_head.py:543-559)."""
    setup_mosh_resolvers()
    merged = _merge(read_config_file(base_config), _dotlist_to_dict(kwargs))
    if dict_cfg:
        merged = _merge(merged, _dotlist_to_dict(dict_cfg))
    return Config(merged)

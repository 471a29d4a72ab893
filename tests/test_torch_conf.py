"""The port's configuration against the JAX package's registry: every key
the JAX package registers is either read by the port or registered there
with the JAX default, raising on any other value (ROADMAP Queue 3's
repaired fault: the port used to ignore such keys in silence)."""
import importlib
import pathlib
import re

import pytest

import spark_rapids_tpu
from spark_rapids_tpu import conf as jconf

from spark_rapids_tpu_torch import conf as pconf
from spark_rapids_tpu_torch.conf import RapidsConf

_JAX_ROOT = pathlib.Path(spark_rapids_tpu.__file__).parent
_REPO = _JAX_ROOT.parent


def _import_registering_modules() -> None:
    """Imports every JAX module that registers a key (several register
    theirs only when imported, e.g. exec/exchange.py and
    exec/transitions.py)."""
    for path in sorted(_JAX_ROOT.rglob("*.py")):
        if "register_conf(" in path.read_text(encoding="utf-8"):
            rel = path.relative_to(_REPO).with_suffix("")
            importlib.import_module(".".join(rel.parts).removesuffix(
                ".__init__"))


_import_registering_modules()
_JAX_ENTRIES = {e.key: e for e in jconf.conf_entries()}
_UNREAD = {k: step for step, keys in pconf._UNREAD_BY_STEP.items()
           for k in keys}


def _other_value(default):
    if isinstance(default, bool):
        return not default
    if isinstance(default, (int, float)):
        return default + 3
    return default + "_other"


def test_late_registering_modules_were_imported():
    for key in ("spark.rapids.tpu.shuffle.mode",
                "spark.rapids.tpu.scan.deviceCache.enabled",
                "spark.rapids.tpu.scan.deviceCache.maxBytes",
                "spark.rapids.tpu.coalesce.afterUpload.enabled"):
        assert key in _JAX_ENTRIES


@pytest.mark.parametrize("key", sorted(_JAX_ENTRIES))
def test_jax_key_is_read_or_raises_unless_default(key):
    """Each JAX key: registered in the port with the JAX default and type;
    a key the port does not read accepts its default (given as is or as a
    string, converted as the JAX entry converts it) and raises on any other
    value, naming the ROADMAP Queue 1 step that will read it."""
    jentry = _JAX_ENTRIES[key]
    entry = pconf._REGISTRY.get(key)
    assert entry is not None, f"{key}: neither read nor refused by the port"
    assert entry.default == jentry.default
    assert entry.conf_type is jentry.conf_type
    if key not in _UNREAD:
        return
    default = jentry.default
    assert RapidsConf({key: default}).get(key) == default
    assert RapidsConf({key: str(default)}).get(key) == default
    if isinstance(default, str) and default:
        case_free = getattr(jentry.checker, "normalize", None) is not None
        assert (key in pconf._CASE_FREE) == case_free
        if case_free:
            assert RapidsConf({key: default.upper()}).get(key) == default
    with pytest.raises(NotImplementedError,
                       match=rf"{re.escape(key)}=.*ROADMAP Queue 1 step "
                       rf"{_UNREAD[key]}\)"):
        RapidsConf({key: _other_value(default)})


def test_unread_table_holds_only_jax_keys():
    assert set(_UNREAD) <= set(_JAX_ENTRIES)
    assert not set(_UNREAD) & {k for k, e in pconf._REGISTRY.items()
                               if e.checker is None}


@pytest.mark.parametrize("key,value", [
    ("spark.rapids.tpu.shuffle.mode", "host"),
    ("spark.rapids.tpu.shuffle.mode", "bogus"),
    ("spark.rapids.tpu.coalesce.afterUpload.enabled", True),
    ("spark.rapids.tpu.coalesce.afterUpload.enabled", "true")])
def test_keys_that_change_the_jax_plan_raise(key, value):
    """``shuffle.mode=host`` puts a host exchange into the JAX plan,
    ``bogus`` makes the JAX package raise, ``coalesce.afterUpload`` adds
    ``TpuCoalesceBatchesExec``: the port runs none of them, so it raises."""
    from spark_rapids_tpu_torch.session import TorchSession
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 step"):
        TorchSession({key: value}, device="cpu")


def test_per_op_and_unknown_keys_still_pass():
    conf = RapidsConf({"spark.rapids.sql.exec.FilterExec": "false",
                       "spark.rapids.sql.expression.Like": False,
                       "spark.sql.some.other": 3})
    assert not conf.is_op_enabled("spark.rapids.sql.exec.FilterExec")
    assert not conf.is_op_enabled("spark.rapids.sql.expression.Like")
    assert conf.is_op_enabled("spark.rapids.sql.exec.ProjectExec")
    assert conf.get("spark.sql.some.other") == 3


def test_no_port_test_or_smoke_phase_sets_an_unread_key():
    """The port's tests and chip_smoke.py set no key the port does not
    read; a line that does configures a JAX session (``TpuSession``)."""
    files = sorted((_REPO / "tests").glob("test_torch_*.py")) \
        + [_REPO / "chip_smoke.py"]
    for path in files:
        if path.name == "test_torch_conf.py":
            continue
        for no, line in enumerate(path.read_text().splitlines(), 1):
            for key in re.findall(r"[\"'](spark\.[\w.]+)[\"']", line):
                if key in _UNREAD:
                    assert "TpuSession(" in line, f"{path.name}:{no} {key}"

"""The port's systemd unit (``deploy/systemd/amw-tpu-torch.service``)
against the JAX package's (``amw-tpu.service``): every field the same
but the description, the environment, the command and the conflict
between the two services (both bind port 8000); the alert unit it names
exists; its command's module resolves and has ``main``.
"""

import configparser
import importlib
import importlib.util
import shlex
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SYSTEMD = ROOT / "deploy" / "systemd"
DIFFERENT = {("Unit", "Description"), ("Service", "Environment"),
             ("Service", "ExecStart"), ("Unit", "Conflicts")}


def unit_fields(path: Path) -> dict:
    """``{(section, key): value}`` of a unit file (keys case-kept)."""
    cp = configparser.ConfigParser(interpolation=None, strict=True)
    cp.optionxform = str
    cp.read_string(path.read_text())
    return {(s, k): v for s in cp.sections() for k, v in cp[s].items()}


def test_units_agree_but_for_the_command():
    jax_unit = unit_fields(SYSTEMD / "amw-tpu.service")
    port = unit_fields(SYSTEMD / "amw-tpu-torch.service")
    assert {k: v for k, v in port.items() if k not in DIFFERENT} == \
        {k: v for k, v in jax_unit.items() if k not in DIFFERENT}
    for key in (("Service", "User"), ("Service", "WorkingDirectory"),
                ("Service", "EnvironmentFile"), ("Unit", "OnFailure"),
                ("Service", "Restart"), ("Service", "RestartSec"),
                ("Service", "LimitNOFILE"), ("Install", "WantedBy")):
        assert port[key] == jax_unit[key], key
    assert port[("Service", "EnvironmentFile")] == "-/opt/amw-tpu/.env"
    assert port[("Unit", "OnFailure")] == "amw-tpu-alert@%n.service"
    assert port[("Unit", "Conflicts")] == "amw-tpu.service"
    assert ("Service", "Environment") not in port
    assert "JAX_PLATFORMS" not in (SYSTEMD / "amw-tpu-torch.service") \
        .read_text()
    assert port[("Service", "ExecStart")] == \
        "/usr/bin/python3 -m amw_tpu_torch.runtime.service"
    # the python path is the one deploy.sh's sed rewrites in the JAX unit
    assert jax_unit[("Service", "ExecStart")].split()[0] == \
        port[("Service", "ExecStart")].split()[0]


def test_alert_unit_exists():
    port = unit_fields(SYSTEMD / "amw-tpu-torch.service")
    name = port[("Unit", "OnFailure")].replace("%n", "")
    assert name == "amw-tpu-alert@.service"
    alert = unit_fields(SYSTEMD / name)
    assert ("Service", "ExecStart") in alert


def test_exec_start_module_resolves():
    argv = shlex.split(unit_fields(SYSTEMD / "amw-tpu-torch.service")[
        ("Service", "ExecStart")])
    assert argv[1] == "-m" and len(argv) == 3
    spec = importlib.util.find_spec(argv[2])
    assert spec is not None and spec.origin.startswith(str(ROOT))
    mod = importlib.import_module(argv[2])
    assert callable(mod.main)
    assert 'if __name__ == "__main__":' in Path(spec.origin).read_text()

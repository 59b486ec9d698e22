"""Doc-drift check: every `--flag` mentioned in README.md / docs/*.md
must exist in cli.py's (or chip_smoke.py's) argparse definitions, and every `SomeConfig.field`
mention must name a real dataclass field (a documented flag that the
CLI does not have is drift).  Exit 1 with a list of stale names on
failure.
"""

import glob
import re
import sys

sys.path.insert(0, ".")


def cli_flags() -> set:
    """Flags of the CLI and of the root scripts the docs describe."""
    src = ""
    for path in ("claragenomicsanalysis_tpu/cli.py", "chip_smoke.py"):
        with open(path) as f:
            src += f.read()
    return set(re.findall(r'"(--[a-z][a-z0-9-]*)"', src))


def config_fields() -> dict:
    import dataclasses

    from claragenomicsanalysis_tpu.core import config as cfg
    out = {}
    for name in dir(cfg):
        obj = getattr(cfg, name)
        if isinstance(obj, type) and dataclasses.is_dataclass(obj):
            out[name] = {f.name for f in dataclasses.fields(obj)}
    return out


def main() -> int:
    flags = cli_flags()
    fields = config_fields()
    stale = []
    docs = ["README.md"] + sorted(glob.glob("docs/*.md"))
    for path in docs:
        with open(path) as f:
            text = f.read()
        for m in re.finditer(r"`(--[a-z][a-z0-9-]*)`", text):
            if m.group(1) not in flags:
                stale.append(f"{path}: {m.group(1)} not in cli.py")
        for m in re.finditer(r"`(\w+Config|BatchSize)\.(\w+)", text):
            cls, field = m.group(1), m.group(2)
            if cls in fields and field not in fields[cls]:
                stale.append(f"{path}: {cls}.{field} is not a field")
    if stale:
        print("STALE doc references:")
        for s in stale:
            print(" ", s)
        return 1
    print(f"doc flags OK ({len(docs)} docs checked against "
          f"{len(flags)} CLI flags, {len(fields)} config classes)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

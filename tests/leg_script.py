"""The subcommands of each leg of ``tools/run_nested_pipeline.sh``, in the
order its body runs them, for the tests that run the port's legs
(``nunerf_tpu_torch.pipeline``) end to end: a leg's record must list the
same subcommands in the same order, each with the script's own arguments up
to the first one the port chains (a shell variable, or a mesh the script
names by the config's step)."""

import os
import re
import shlex

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "tools", "run_nested_pipeline.sh")
CLI = re.compile(r"python -m nunerf_tpu\.cli (.*)$")
EVAL_SHELL = re.compile(r"python tools/eval_shell\.py\b")


def bodies():
    """{leg: its body's text} of the script's functions."""
    with open(SCRIPT) as f:
        script = f.read()
    return dict(re.findall(r"^(\w+)\(\) \{\n(.*?)^\}", script, flags=re.M | re.S))


def script_commands(leg, _bodies=None):
    """[(subcommand, the script's fixed leading arguments)] of ``leg``'s
    body, a call of another leg's function expanded in place."""
    _bodies = bodies() if _bodies is None else _bodies
    out = []
    for line in _bodies[leg].replace("\\\n", " ").splitlines():
        line = line.strip()
        if line.startswith("#"):
            continue
        call = re.match(r"(\w+) \"\$1\"$", line)
        if call and call.group(1) in _bodies:
            out += script_commands(call.group(1), _bodies)
        elif EVAL_SHELL.search(line):
            out.append(("eval_shell", None))
        elif CLI.search(line):
            argv = []
            for tok in shlex.split(CLI.search(line).group(1)):
                if "$" in tok or tok.startswith("data/meshes/"):
                    break
                argv.append(tok)
            out.append((argv[0], argv))
    return out


def assert_runs_script(record):
    """``record`` (``pipeline.run_leg``'s) ran its leg's subcommands as the
    script's body does."""
    want = script_commands(record["leg"])
    assert [c["command"] for c in record["commands"]] == [w[0] for w in want]
    for c, (_, fixed) in zip(record["commands"], want):
        if fixed is None:
            continue
        argv = c["argv"][1:] if c["argv"][0] == "nunerf_tpu_torch.cli" else c["argv"]
        assert argv[:len(fixed)] == fixed, (c["argv"], fixed)

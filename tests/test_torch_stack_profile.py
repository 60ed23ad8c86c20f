"""``reak_tpu_torch.io.stack_profile``: a script's wall time by sampled
stacks, on a script that sleeps in two places."""
import json
import sys

from reak_tpu_torch.io import stack_profile

SCRIPT = """\
import sys, time


def slow():
    time.sleep(1.5)


def fast():
    time.sleep(0.5)


slow()
fast()
sys.exit(int(sys.argv[1]))
"""


def test_sampled_seconds_land_on_the_lines_that_sleep(tmp_path,
                                                      monkeypatch):
    script, out = tmp_path / "script.py", tmp_path / "out.json"
    script.write_text(SCRIPT)
    monkeypatch.setattr(stack_profile, "EVERY", 0.05)
    argv = sys.argv
    # the script's exit code comes back; its argv was its own
    assert stack_profile.main([str(out), str(script), "3"]) == 3
    assert sys.argv == argv
    got = json.loads(out.read_text())
    line, chain = dict(got["line"]), dict(got["chain"])
    assert 1.0 <= line["slow:5"] <= 2.0
    assert 0.2 <= line["fast:9"] <= 1.0
    assert chain["<module>:12 > slow:5"] == line["slow:5"]
    assert chain["<module>:13 > fast:9"] == line["fast:9"]
    # the profiler's own frames are not the package's
    assert got["package"] == []

"""The reference's graftlint holds the port to the same invariants.

graftlint (``ray_tpu.tools.graftlint``, only imported here; the port
imports nothing of ``ray_tpu``) checks the concurrency and message rules
of the runtime, GL012 among them: every message type sent has a
receiver and every handled type a sender. Before the node agent and the
CLI were ported, the hub's ten node-agent messages and the CLI's
``shutdown`` had only one end each. Over ``ray_tpu_torch/`` with no
baseline it now reports nothing.
"""

import io
import json
import os
from contextlib import redirect_stdout

from ray_tpu.tools.graftlint.__main__ import main

PORT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "ray_tpu_torch")


def test_graftlint_finds_nothing_in_the_port():
    out = io.StringIO()
    with redirect_stdout(out):
        rc = main([PORT, "--no-baseline", "--format", "json"])
    report = json.loads(out.getvalue())
    assert report["findings"] == [], report["findings"]
    assert rc == 0

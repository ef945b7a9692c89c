"""The edit tables of the card tools against the kernel sources as they
stand: every planted fault of ``tools/*_planted_faults.py`` and every
variant of ``tools/kernel_variants.py`` names text that occurs exactly once
in its ``csrc/*.cu``, the check ``tools/_faults.build_variants`` makes on the
card before it builds anything.  A kernel rewrite that leaves a tool's table
behind fails here, on the CPU."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc")
sys.path.insert(0, os.path.join(ROOT, "tools"))

import _faults  # noqa: E402
import decode_planted_faults  # noqa: E402
import distill_planted_faults  # noqa: E402
import flash_planted_faults  # noqa: E402
import kernel_variants  # noqa: E402
import ssd_planted_faults  # noqa: E402

# each planted-fault tool and the source its build_variants call edits
FAULT_TOOLS = ((flash_planted_faults, "flash_attention"),
               (decode_planted_faults, "decode_attention"),
               (distill_planted_faults, "distill_loss"),
               (ssd_planted_faults, "ssd_chunk"))
CASES = [(f"{tool.__name__}: {name}", source, edits)
         for tool, source in FAULT_TOOLS
         for name, edits in tool.FAULTS.items()]
CASES += [(f"kernel_variants.{group}: {name}", source, edits)
          for group, (source, table) in kernel_variants.SOURCES.items()
          for name, edits in table.items()]


@pytest.mark.parametrize("source,edits", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_tool_edits_match_their_source_once(source, edits):
    with open(os.path.join(CSRC, f"{source}.cu")) as fh:
        text = fh.read()
    assert _faults.apply_edits(text, edits, source) != text


def test_every_planted_fault_tool_is_covered():
    """A new ``tools/*_planted_faults.py`` joins FAULT_TOOLS above."""
    have = {f[:-3] for f in os.listdir(os.path.join(ROOT, "tools"))
            if f.endswith("_planted_faults.py")}
    assert have == {tool.__name__ for tool, _ in FAULT_TOOLS}

"""The plain references the benchmark holds the program against, one module
an architecture, named by the configuration.

A model entry of ``configs/<config>.json`` may carry ``"reference":
"<module>"``, naming ``reference/<module>.py``; without the key the module
is `lm` (the llama-style block with an optional top-k MoE).  `pbench.check`
loads each model's module by that name; `pbench.cell` loads them all at
set-up, before any weight is drawn, so a missing module stops a run there.

The contract of a reference module:

  * ``forward(weights, cfg, seqs, *, device, precisions=("fp32",))`` gives,
    for each precision and each sequence, float32 logits, as `lm.forward`
    does: `weights` are the drawn leaves by the program's leaf names, `cfg`
    the configuration's ``port`` section (the program's field names, with
    ``head_dim`` resolved), and each of `seqs` is (tokens, prompt_len, rows):
    the first `prompt_len` tokens were the prompt, the rest were decoded one
    at a time, and the logits (len(rows), V) are at positions `rows`;
  * under the precision ``"fp8"`` every matrix product takes its operands
    rounded to float8 e4m3 (the control);
  * it computes in plain float32 with TF32 off on a card
    (``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` set False), and moves weights to the
    device a layer at a time, so that a model larger than the free memory
    fits;
  * it imports neither the program (`repro_torch`) nor the harness
    (`pbench`), and takes nothing that the program made.
"""
from __future__ import annotations

import importlib
import importlib.util
from pathlib import Path
from typing import Mapping

DEFAULT = "lm"
DIR = Path(__file__).resolve().parent


def module_of(model: Mapping) -> str:
    """The reference module a configuration's model entry names."""
    return model.get("reference", DEFAULT)


def load(module: str):
    """Reference module `module` (``reference/<module>.py``); raises
    ModuleNotFoundError, naming the file, where there is none."""
    if not module.isidentifier() or importlib.util.find_spec(f"{__name__}.{module}") is None:
        raise ModuleNotFoundError(f"no reference module {DIR / (module + '.py')}")
    return importlib.import_module(f"{__name__}.{module}")

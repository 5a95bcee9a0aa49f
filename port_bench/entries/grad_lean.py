"""Inverse rendering on the lean engine: ``grad``'s unit, set-up and check
under a traffic name of its own.

A step is ``entries/grad.py``'s: one gradient step of ``spp`` samples per
pixel through the program's ``render/diff.loss_and_grad_rays`` and an Adam
step on the fitted colours.  What puts the step on the lean engine
(``render/diff.LeanSample``: a forward that keeps its residuals, a re-trace
of the lean scan, PyTorch shading checkpointed each bounce) is the
workload's ``render`` object, merged over the configuration's settings by
``cellkit.render_settings``.  The check is ``grad``'s, against the same
plain reference, which does not depend on the engine.
"""

from port_bench.entries.grad import Cell, check, compare, program_calls, reference_outputs

__all__ = ["Cell", "check", "compare", "program_calls", "reference_outputs"]

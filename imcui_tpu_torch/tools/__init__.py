"""Command-line probes of the port's kernels, counterparts of the JAX
package's ``tools/`` scripts. Run on a card, e.g.
``python -m imcui_tpu_torch.tools.tail_probes``."""

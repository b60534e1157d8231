"""Model configurations that state a published model's own mechanisms.

``ModelConfig`` is the JAX reference's configuration, field for field and
value for value (``tests/test_torch_package.py`` pins the two), so a
published model whose equations need a switch that the reference lacks is
configured here, by a subclass that adds the switches.  Their defaults are
the reference's behaviour, and the model code reads them with
``getattr(cfg, name, default)``, so a plain ``ModelConfig`` runs as before:

* ``qk_norm``: an RMSNorm over the whole q width and the whole k width,
  after the projections and before RoPE, with a learned scale each
  (``attn.q_norm``, ``attn.k_norm``); the cache holds the normalised keys
  (OLMoE);
* ``norm_topk_prob``: whether the top-k router probabilities are
  renormalised to sum to one before they weight the experts (OLMoE: no);
* ``moe_dropless``: every one of the T·k routed entries is computed (the
  entries sorted by expert on the device, the experts' products grouped over
  the sorted rows, ``models.moe.dropless_moe``), where the reference keeps
  C = max(ceil(T·k/E·cf), 8) entries an expert and drops the rest.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class PublishedConfig(ModelConfig):
    qk_norm: bool = False
    norm_topk_prob: bool = True
    moe_dropless: bool = False

    def param_count(self) -> int:
        """``ModelConfig.param_count`` plus the q and k norm scales."""
        n = super().param_count()
        if self.qk_norm:
            n += self.n_layers * (self.n_heads + self.n_kv_heads) * self.head_dim
        return n

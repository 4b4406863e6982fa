"""Posterior container + summaries (port of :mod:`nestmc.posterior`)."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from nestmc_torch.diagnostics import _quantile, diagnose_chunked


@dataclass
class Posterior:
    """Sampling results.

    draws: {block: (chains, draws, ...)} retained draws on the device.
    accept_rates / warmup_accept_rates: {block: (chains, units)} mean
      acceptance over the sampling / warmup phase.
    config: SamplerConfig dict. timings: wall-clock seconds per phase.
    full_rhat: {block: classic split R-hat over every unit} and full_ess:
      {block: {"ess", "ess_lb"}} cross-chain ESS with its one-sided 95%
      lower bound, both from the streamed accumulators (RunConfig.full_rhat).
    final_state (set by the engine): the carry at the end of the run.

    Of a sharded run (one rank of it): draws and the R-hat and ESS maps
    are the global layout, as unsharded; final_state, accept_rates and
    warmup_accept_rates are this rank's parts, placed by ``placement``
    (parallel.sharding.Placement; parallel.gather_state and gather_rates
    give the global layout, a collective every rank calls), and
    accept_mean holds each block's global mean acceptance, which the
    summaries report. Both are None unsharded.

    spans: the draw step's span recorder (utils/profiling.Spans) of a
    ``sample(..., spans=True)`` run, else None.
    """

    draws: dict
    accept_rates: dict
    warmup_accept_rates: dict
    config: dict
    timings: dict = field(default_factory=dict)
    full_rhat: dict | None = None
    full_ess: dict | None = None
    placement: object | None = None
    accept_mean: dict | None = None
    spans: object | None = None
    _diag_cache: dict | None = None

    def _mean_accept(self, name: str):
        """The mean sampling acceptance of block ``name`` over every chain
        and unit (a 0-d tensor)."""
        if self.accept_mean is not None:
            return self.accept_mean[name]
        return self.accept_rates[name].mean()

    def diagnostics(self) -> dict:
        if self._diag_cache is None:
            self._diag_cache = diagnose_chunked(self.draws)
        return self._diag_cache

    def worst_rhat(self) -> float:
        """Max of the rank-normalised R-hat over the collected scalars and
        the classic streamed split R-hat over every unit of every block."""
        vals = [v["rhat"].max() for v in self.diagnostics().values()]
        if self.full_rhat is not None:
            vals += [v.max() for v in self.full_rhat.values()]
        if not vals:
            return float("nan")
        return float(torch.stack([v.float().cpu() for v in vals]).max())

    def worst_rhat_at(self) -> dict | None:
        """{'block', 'index', 'rhat', 'kind'} of the largest R-hat that
        worst_rhat reports: 'rank' (a collected scalar's rank-normalised
        R-hat) or 'streamed' (a unit's classic split R-hat)."""
        best = None
        sources = [("rank", k, v["rhat"]) for k, v in
                   self.diagnostics().items()]
        sources += [("streamed", k, v) for k, v in
                    (self.full_rhat or {}).items()]
        for kind, name, r in sources:
            r = r.float().cpu().numpy()
            idx = int(np.argmax(r))
            val = float(r.ravel()[idx])
            if best is None or val > best["rhat"]:
                best = {"block": name, "kind": kind, "rhat": val,
                        "index": tuple(int(i) for i in
                                       np.unravel_index(idx, r.shape))}
        return best

    def total_ess(self, kind: str = "ess_bulk") -> float:
        """Sum of ESS over every collected scalar parameter."""
        d = self.diagnostics()
        return float(sum(float(v[kind].sum()) for v in d.values()))

    def min_ess(self, kind: str = "ess_bulk") -> float:
        d = self.diagnostics()
        if not d:
            return 0.0
        return float(min(float(v[kind].min()) for v in d.values()))

    def min_ess_argmin(self, kind: str = "ess_bulk") -> dict | None:
        """{'block', 'index', 'ess'} of the lowest-ESS collected scalar."""
        best = None
        for name, stats in self.diagnostics().items():
            e = stats[kind].cpu().numpy()
            idx = int(np.argmin(e))
            val = float(e.ravel()[idx])
            if best is None or val < best["ess"]:
                best = {
                    "block": name,
                    "index": tuple(
                        int(i) for i in np.unravel_index(idx, e.shape)
                    ),
                    "ess": val,
                }
        return best

    def min_ess_all_params(self) -> dict | None:
        """{'block', 'index', 'ess', 'ess_lb'} at the lowest streamed
        cross-chain ESS over every parameter; None without full_rhat."""
        if not self.full_ess:
            return None
        best = None
        for name, stats in self.full_ess.items():
            e = stats["ess"].cpu().numpy()
            idx = int(np.argmin(e))
            val = float(e.ravel()[idx])
            if best is None or val < best["ess"]:
                best = {
                    "block": name,
                    "index": tuple(
                        int(i) for i in np.unravel_index(idx, e.shape)
                    ),
                    "ess": val,
                    "ess_lb": float(stats["ess_lb"].cpu().numpy().ravel()[idx]),
                }
        return best

    def _pooled(self, name: str):
        x = self.draws[name]
        return x.reshape((-1,) + tuple(x.shape[2:]))

    def mean(self, name: str):
        """Posterior mean of a collected quantity over chains and draws."""
        return self._pooled(name).mean(dim=0)

    def var(self, name: str, ddof: int = 1):
        """Posterior variance of a collected quantity over chains and
        draws, with ``ddof`` degrees of freedom taken off."""
        return torch.var(self._pooled(name), dim=0, correction=ddof)

    def quantile(self, name: str, q):
        """Posterior quantile(s) ``q`` (linear interpolation, as
        jnp.quantile) over chains and draws; a leading axis per q when
        ``q`` is a sequence."""
        x = self._pooled(name)
        if isinstance(q, (int, float)):
            return _quantile(x, float(q))
        return torch.stack([_quantile(x, float(v)) for v in q])

    def summarize(self) -> dict:
        """{block: {statistic: numpy array}} of the diagnostics, with each
        MH block's mean 'accept_rate' (derived quantities have none)."""
        out = {}
        for name, stats in self.diagnostics().items():
            out[name] = {k: v.cpu().numpy() for k, v in stats.items()}
            if name in self.accept_rates:
                out[name]["accept_rate"] = self._mean_accept(
                    name).cpu().numpy()
        return out

    def summary_table(self) -> str:
        """Fixed-width table of per-block aggregates."""
        lines = [
            f"{'block':<14}{'mean':>10}{'sd':>10}{'rhat_max':>10}"
            f"{'ess_min':>10}{'ess_sum':>12}{'acc':>7}"
        ]
        for name, s in self.diagnostics().items():
            acc = (
                f"{float(self._mean_accept(name)):>7.2f}"
                if name in self.accept_rates else f"{'-':>7}"
            )
            lines.append(
                f"{name:<14}"
                f"{float(s['mean'].mean()):>10.3f}"
                f"{float(s['sd'].mean()):>10.3f}"
                f"{float(s['rhat'].max()):>10.4f}"
                f"{float(s['ess_bulk'].min()):>10.0f}"
                f"{float(s['ess_bulk'].sum()):>12.0f}"
                f"{acc}"
            )
        return "\n".join(lines)

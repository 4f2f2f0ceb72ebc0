"""5G-NR cell search: PSS/SSS matched filtering on torch.fft.

The port of iqwaveform_tpu/models/cellsearch.py. It builds on the
sync-sequence banks (models.ofdm.pss_5g_nr / sss_5g_nr, reference
ofdm.py:123-448), which the reference generates without a searcher:

1. PSS stage: correlate the capture against all 3 N_id2 sequences at once
   (one batched FFT product), normalize by local input power, pick the
   strongest (N_id2, sample offset).
2. SSS stage (optional): correlate the symbol two slots later against the
   SSS candidates consistent with N_id2 to recover the full cell ID
   N_id = 3*N_id1 + N_id2.

The templates are built on the host from the same arguments as the JAX
package's and moved to the device once.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils import resolve_device, to_device
from . import ofdm

__all__ = ['CellSearch', 'CellSearchResult']


@dataclasses.dataclass
class CellSearchResult:
    n_id2: int
    offset: int  # sample index of the PSS sequence start
    peak: float  # normalized correlation magnitude at the peak
    n_id: int | None = None  # full cell ID when SSS search ran
    sss_peak: float | None = None


class CellSearch:
    """matched-filter 5G-NR cell searcher.

    Usage:
        search = CellSearch(sample_rate=7.68e6, subcarrier_spacing=15e3)
        result = search(iq)                  # numpy or tensor input

    ``device``: where the input goes (None: the card).
    """

    def __init__(
        self,
        sample_rate: float,
        subcarrier_spacing: float = 15e3,
        center_frequency: float = 0.0,
        device=None,
    ):
        self.sample_rate = sample_rate
        self.subcarrier_spacing = subcarrier_spacing
        self.device = resolve_device(device)

        # matched-filter templates, built on the host
        bank = dict(center_frequency=center_frequency, pad_cp=False)
        self._pss = np.asarray(ofdm.pss_5g_nr(sample_rate, subcarrier_spacing, **bank))
        self._sss = np.asarray(ofdm.sss_5g_nr(sample_rate, subcarrier_spacing, **bank))
        self._templates = {
            'pss': torch.from_numpy(self._pss).to(self.device),
            'sss': torch.from_numpy(self._sss).to(self.device),
        }
        self.nfft = round(sample_rate / subcarrier_spacing)
        # symbol stride between PSS and SSS: PSS occupies symbol k, SSS
        # symbol k+2 (reference ofdm.py:429-438); at 15/30 kHz SCS each
        # intervening symbol spans nfft + cp samples
        cp = round(9 * sample_rate / subcarrier_spacing / 128)
        self.sss_stride = 2 * (self.nfft + cp)

    def _normalized_corr(self, x: torch.Tensor, templates: torch.Tensor) -> torch.Tensor:
        """|matched filter| / sqrt(local energy), shape (n_templates, L)."""
        n = x.shape[0]
        m = templates.shape[1]
        nfft = 1 << int(np.ceil(np.log2(n + m - 1)))

        X = torch.fft.fft(x, n=nfft)
        T = torch.fft.fft(templates, n=nfft, dim=1)
        corr = torch.fft.ifft(X[None, :] * T.conj(), dim=1)[:, : n - m + 1]

        # local input energy over each m-sample window: a float32 cumsum
        # difference, the JAX package's formula
        p = x.real * x.real + x.imag * x.imag
        cs = torch.cumsum(torch.cat([p.new_zeros(1), p]), dim=0)
        energy = cs[m:] - cs[: n - m + 1]
        t_energy = (templates.real * templates.real + templates.imag * templates.imag).sum(dim=1)

        denom = torch.sqrt(torch.clamp(energy[None, :] * t_energy[:, None], min=1e-20))
        return corr.abs() / denom

    def _pss_score(self, x: torch.Tensor) -> torch.Tensor:
        """(3, L) normalized PSS correlation."""
        return self._normalized_corr(x, self._templates['pss'])

    def _sss_scores_at(self, x: torch.Tensor, start: int) -> torch.Tensor:
        """normalized correlation of the SSS symbol at sample offset
        ``start`` against all 1008 SSS candidates -> (1008,)."""
        m = self._sss.shape[1]
        segment = x[start : start + m]
        return self._normalized_corr(
            torch.cat([segment, segment.new_zeros(1)]), self._templates['sss']
        )[:, 0]

    def __call__(self, iq, search_sss: bool = True) -> CellSearchResult:
        """run the search; the peak picking reads back one index and one
        score per stage."""
        iq = to_device(iq, self.device, torch.complex64)
        score = self._pss_score(iq)
        flat = int(score.argmax())
        n_id2, offset = divmod(flat, score.shape[1])
        peak = float(score[n_id2, offset])

        result = CellSearchResult(n_id2=n_id2, offset=offset, peak=peak)

        if not search_sss:
            return result

        sss_start = offset + self.sss_stride
        m = self._sss.shape[1]
        if sss_start + m > iq.shape[0]:
            return result  # capture too short for the SSS symbol

        # candidates consistent with n_id2: N_id = 3*N_id1 + n_id2
        sss_score = self._sss_scores_at(iq, sss_start)[n_id2::3]
        best = int(sss_score.argmax())
        result.n_id = 3 * best + n_id2
        result.sss_peak = float(sss_score[best])
        return result

"""Reference-compatible facade for ofdm (reference ofdm.py), with the
names of iqwaveform_tpu/ofdm.py. Implementations live in
iqwaveform_torch.models.ofdm."""

import typing

import numpy as np
import torch

from .models.ofdm import (  # noqa: F401
    BasebandClockSynchronizer,
    Phy3GPP,
    Phy802_16,
    PhyOFDM,
    SymbolDecoder,
    SyncParams,
    call_by_block,
    corr_at_indices,
    correlate_along_axis,
    empty_complex64,
    indexsum2d,
    pss_5g_nr,
    pss_params,
    sss_5g_nr,
    sss_params,
    subsample_shift,
    to_blocks,
)
from .models.ofdm import _pss_m_sequence, _sss_m_sequence  # noqa: F401

# names the reference's ofdm module also exposes via its own imports
from .utils import (  # noqa: F401
    array_namespace,
    isclosetoint,
    isroundmod,
    lru_cache,
    pad_along_axis,
)

# the two array backends of the port: host numpy and torch tensors
ArrayType = typing.Union[np.ndarray, torch.Tensor]

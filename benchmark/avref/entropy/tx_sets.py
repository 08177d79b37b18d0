"""Transform-set signaling machinery (spec 5.11.47/8.3.2; reference
``EbDefinitions.h:1429-1482``, ``EbCabacContextModel.h:1075``)."""

from __future__ import annotations

import numpy as np

from benchmark.avref.utils.blocks import (DCT_DCT, MODE_TO_TXFM, TX_16X16,
                                      TX_32X32, TX_SIZE_SQR, TX_SIZE_SQR_UP,
                                      UV_CFL_PRED)

EXT_TX_SET_DCTONLY = 0
EXT_TX_SET_DCT_IDTX = 1
EXT_TX_SET_DTT4_IDTX = 2
EXT_TX_SET_DTT4_IDTX_1DDCT = 3
EXT_TX_SET_DTT9_IDTX_1DDCT = 4
EXT_TX_SET_ALL16 = 5

NUM_EXT_TX_SET = [1, 2, 5, 7, 12, 16]

EXT_TX_USED = np.array([
    [1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [1, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0],
    [1, 1, 1, 1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0],
    [1, 1, 1, 1, 0, 0, 0, 0, 0, 1, 1, 1, 0, 0, 0, 0],
    [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0],
    [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
])

# symbol index of each tx type within a set / inverse mapping
EXT_TX_IND = np.array([
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [1, 3, 4, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [1, 5, 6, 4, 0, 0, 0, 0, 0, 0, 2, 3, 0, 0, 0, 0],
    [3, 4, 5, 8, 6, 7, 9, 10, 11, 0, 1, 2, 0, 0, 0, 0],
    [7, 8, 9, 12, 10, 11, 13, 14, 15, 0, 1, 2, 3, 4, 5, 6],
])
EXT_TX_INV = np.array([
    [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [9, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [9, 0, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [9, 0, 10, 11, 3, 1, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0],
    [9, 10, 11, 0, 1, 2, 4, 5, 3, 6, 7, 8, 0, 0, 0, 0],
    [9, 10, 11, 12, 13, 14, 15, 0, 1, 2, 4, 5, 3, 6, 7, 8],
])

# set-type -> cdf set index, per is_inter
EXT_TX_SET_INDEX = [[0, -1, 2, 1, -1, -1], [0, 3, -1, -1, 2, 1]]


def ext_tx_set_type(tx_size: int, is_inter: bool, reduced: bool) -> int:
    sqr_up = int(TX_SIZE_SQR_UP[tx_size])
    if sqr_up > TX_32X32:
        return EXT_TX_SET_DCTONLY
    if sqr_up == TX_32X32:
        return EXT_TX_SET_DCT_IDTX if is_inter else EXT_TX_SET_DCTONLY
    if reduced:
        return EXT_TX_SET_DCT_IDTX if is_inter else EXT_TX_SET_DTT4_IDTX
    sqr = int(TX_SIZE_SQR[tx_size])
    if is_inter:
        return (EXT_TX_SET_DTT9_IDTX_1DDCT if sqr == TX_16X16
                else EXT_TX_SET_ALL16)
    return (EXT_TX_SET_DTT4_IDTX if sqr == TX_16X16
            else EXT_TX_SET_DTT4_IDTX_1DDCT)


def ext_tx_set(tx_size: int, is_inter: bool, reduced: bool) -> int:
    return EXT_TX_SET_INDEX[int(is_inter)][
        ext_tx_set_type(tx_size, is_inter, reduced)]


def num_ext_tx_types(tx_size: int, is_inter: bool, reduced: bool) -> int:
    return NUM_EXT_TX_SET[ext_tx_set_type(tx_size, is_inter, reduced)]


def uv_tx_type(uv_mode: int, tx_size: int, reduced: bool) -> int:
    """Chroma tx type is derived, not signaled (spec compute_tx_type)."""
    from benchmark.avref.utils.blocks import TX_32X32 as _T32
    if int(TX_SIZE_SQR_UP[tx_size]) > _T32:
        return DCT_DCT
    if uv_mode == UV_CFL_PRED:
        return DCT_DCT
    t = int(MODE_TO_TXFM[uv_mode])
    set_type = ext_tx_set_type(tx_size, False, reduced)
    if not EXT_TX_USED[set_type][t]:
        return DCT_DCT
    return t

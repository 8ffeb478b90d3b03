"""The ``build_split_fns`` shim of ``repro_torch.core.collab.runtime``: a
one-shot ``SplitFnBank``, whose functions give the bank's bits and the
reference's ``build_split_fns`` results within ``torch_parity.fp32_tol``
(the same fp32 convolutions in other summation orders), for plain,
masked, packed, compacted and int8 deployments of the tiny CNN at every
class of split (0, an interior one, N)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.collab import quant as rquant
from repro.core.collab import runtime as rrt
from repro_torch.core.collab import quant as tquant
from repro_torch.core.collab import runtime as trt
from torch_parity import (fp32_tol, port_masks, port_params, ref_tree,
                          tiny_setup)
from torch_parity import one_thread  # noqa: F401 (autouse)

#: (masked, compact, pack, int8)
DEPLOYMENTS = {"dense": (False, False, False, False),
               "masked": (True, False, False, False),
               "packed": (True, False, True, False),
               "compact": (True, True, False, False),
               "compact_int8": (True, True, False, True)}


@pytest.mark.parametrize("deployment", sorted(DEPLOYMENTS))
def test_build_split_fns_matches_bank_and_reference(deployment):
    masked, compact, pack, int8 = DEPLOYMENTS[deployment]
    cfg_r, cfg_t, pn, mn, x = tiny_setup()
    n = len(cfg_t.layers)
    x = x[:1]
    rmasks = ({i: jnp.asarray(m) for i, m in mn.items()} if masked
              else None)
    tmasks = port_masks(mn) if masked else None
    rq = rquant.QuantPolicy(weight_bits=8) if int8 else None
    tq = tquant.QuantPolicy(weight_bits=8) if int8 else None
    bank = trt.SplitFnBank(port_params(pn), cfg_t, tmasks, compact, pack,
                           quant=tq, device="cpu")
    for split in (0, 6, n):
        edge, cloud, keep, dcfg = trt.build_split_fns(
            port_params(pn), cfg_t, split, tmasks, compact, pack, quant=tq,
            device="cpu")
        r_edge, r_cloud, r_keep, r_dcfg = rrt.build_split_fns(
            ref_tree(pn), cfg_r, split, rmasks, compact, pack, quant=rq)
        b_edge, b_cloud, b_keep = bank.get(split)
        assert dcfg == bank.deploy_cfg
        assert [s.kind for s in dcfg.layers] == [s.kind for s in
                                                 r_dcfg.layers]
        assert [getattr(s, "out_channels", None) for s in dcfg.layers] == [
            getattr(s, "out_channels", None) for s in r_dcfg.layers]
        assert (keep is None) == (r_keep is None) == (b_keep is None)
        if keep is not None:
            assert np.array_equal(np.asarray(keep), np.asarray(r_keep))
        assert (edge is None) == (r_edge is None) == (split == 0)
        assert (cloud is None) == (r_cloud is None) == (split == n)
        feat, r_feat = x, jnp.asarray(x)
        if edge is not None:
            got = bank.call(edge, x)
            assert np.array_equal(got, bank.call(b_edge, x))
            r_feat = r_edge(r_feat)
            want = np.asarray(r_feat)
            assert np.abs(got - want).max() <= fp32_tol(want)
            feat = got
        if cloud is not None:
            got = bank.call(cloud, feat)
            assert np.array_equal(got, bank.call(b_cloud, feat))
            want = np.asarray(r_cloud(jnp.asarray(feat)))
            assert np.abs(got - want).max() <= fp32_tol(want)
    assert torch.is_tensor(bank.tensor(x))

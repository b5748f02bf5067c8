"""The port's behaviour server against the JAX package's on the CPU, in
float64.

The same state sequence goes to `dftpav_tpu.urban.behavior_server.
BehaviorServer` and to the port's, tick by tick: the EUDM manager scenarios
of tests/test_urban.py (a committed lane change roots the next tree, a
completed one collapses the root to LK) as six stamped ticks, three ticks
on the automatic clock, autonomous level 2 (lane keep, no planner), and
MPDM with the HMI lock. Equal per tick: behaviour, reference lane,
validity and the DCP root (ongoing_lat); the snapshot's action sequence,
committed change and its target lane. To 1e-9: the desired velocity
(relative) and the forward trajectory (absolute).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dftpav_tpu.urban import eudm as jeudm
from dftpav_tpu.urban import forward_sim as jfsim
from dftpav_tpu.urban import lane as jlane
from dftpav_tpu.urban import mpdm as jmpdm
from dftpav_tpu.urban.behavior_server import BehaviorServer as JServer

from dftpav_tpu_torch.urban import eudm, forward_sim as fsim
from dftpav_tpu_torch.urban import lane as lane_mod, mpdm
from dftpav_tpu_torch.urban.behavior_server import BehaviorServer

torch.set_num_threads(1)

# tests/test_urban.py's slow leader, the ego 3 cm off its lane centre
SLOW_LEADER = [[0.0, 0.03, 0.0, 5.0, 0.0, 0.0],
               [25.0, -0.04, 0.0, 1.0, 0.0, 0.0]]
# the ego crossing to the left lane (arriving at the fourth state) behind
# the slow leader
CROSSING = [
    [[6.0, 1.4, 0.25, 5.0, 0.0, 0.0], [26.0, -0.04, 0.0, 1.0, 0.0, 0.0]],
    [[9.0, 2.6, 0.15, 5.5, 0.0, 0.0], [26.4, -0.04, 0.0, 1.0, 0.0, 0.0]],
    [[11.5, 3.46, 0.02, 6.0, 0.0, 0.0], [26.8, -0.04, 0.0, 1.0, 0.0, 0.0]],
    [[14.0, 3.52, 0.0, 6.5, 0.0, 0.0], [27.2, -0.04, 0.0, 1.0, 0.0, 0.0]],
    [[17.0, 3.48, 0.0, 7.0, 0.0, 0.0], [27.6, -0.04, 0.0, 1.0, 0.0, 0.0]],
]


@pytest.fixture(scope="module")
def net():
    def lane(y):
        return jlane.build_lane(np.stack([np.linspace(0, 200, 21),
                                          y * np.ones(21)], 1),
                                ds=1.0, P=256, dtype=np.float64)
    jls = jlane.build_lane_set([lane(0.0), lane(3.5)], [1, -1], [-1, 0])
    ls = lane_mod.lane_set_from_numpy(
        [np.asarray(f) for f in jls.lanes], np.asarray(jls.left_id),
        np.asarray(jls.right_id), device="cpu", dtype=torch.float64)
    ones = np.ones(2)
    vals = (4.88, 1.9, 1.015, 2.85)
    jg = jfsim.AgentGeom(*(jnp.asarray(v * ones) for v in vals))
    g = fsim.AgentGeom(*(torch.from_numpy(v * ones) for v in vals))
    return jls, ls, jg, g


def servers(net, planner, **kw):
    jls, ls, jg, g = net
    jcfg = pcfg = None
    if planner == "eudm":
        jcfg = jeudm.EUDMConfig(desired_velocity=8.0)
        pcfg = eudm.EUDMConfig(desired_velocity=8.0)
    elif kw.get("autonomous_level", 3) >= 3:
        jcfg = jmpdm.MPDMConfig(desired_velocity=8.0)
        pcfg = mpdm.MPDMConfig(desired_velocity=8.0)
    return (JServer(jls, jg, 0, planner=planner, cfg=jcfg, **kw),
            BehaviorServer(ls, g, 0, planner=planner, cfg=pcfg, **kw))


def check_tick(dec, jdec):
    assert dec.behavior == jdec.behavior
    assert dec.ref_lane_id == jdec.ref_lane_id
    assert dec.valid == jdec.valid
    assert dec.ongoing_lat == jdec.ongoing_lat
    np.testing.assert_allclose(dec.desired_vel, jdec.desired_vel, rtol=1e-9)
    np.testing.assert_allclose(dec.forward_traj, np.asarray(
        jdec.forward_traj), rtol=0.0, atol=1e-9)


def check_snapshot(srv, jsrv):
    s, j = srv._snapshot, jsrv._snapshot
    np.testing.assert_array_equal(s.action_seq, np.asarray(j.action_seq))
    assert (s.stamp, s.valid, s.risky, s.lc_lat, s.lc_target) == \
        (j.stamp, j.valid, j.risky, j.lc_lat, j.lc_target)


def test_eudm_stamped_ticks_match_jax(net):
    """Six stamped ticks through a lane change: the committed LCL roots
    the ticks mid-change, and arriving on the target lane collapses the
    root to LK; beside it a server without context roots at LK."""
    jsrv, srv = servers(net, "eudm")
    seq = [SLOW_LEADER] + CROSSING
    roots = []
    for k, st in enumerate(seq):
        if k == 0:
            stamp = 0.0
        elif k == 1:
            # mid-change, inside the layer of the sequence's first LCL
            lat = srv._snapshot.action_seq[:, 1]
            stamp = (int(np.argmax(lat == mpdm.LCL)) + 0.3) \
                * srv.cfg.layer_time
        else:
            stamp += 0.4
        jdec = jsrv.tick(jnp.asarray(st), stamp=stamp)
        dec = srv.tick(np.asarray(st), stamp=stamp)
        check_tick(dec, jdec)
        check_snapshot(srv, jsrv)
        roots.append(dec.ongoing_lat)
        if k == 0:
            assert dec.behavior == mpdm.LCL
            assert srv._snapshot.lc_lat == mpdm.LCL
    assert roots[0] == mpdm.LK and roots[1] == mpdm.LCL
    assert roots[-1] == mpdm.LK
    fresh = BehaviorServer(net[1], net[3], 0, planner="eudm",
                           cfg=eudm.EUDMConfig(desired_velocity=8.0))
    fresh.tick(np.asarray(CROSSING[0]), stamp=1.0)
    assert int(fresh._snapshot.action_seq[0, 1]) == mpdm.LK


def test_eudm_auto_clock_ticks_match_jax(net):
    """Without stamps the clock advances 0.05 s per tick."""
    jsrv, srv = servers(net, "eudm")
    for st in [SLOW_LEADER] + CROSSING[:2]:
        check_tick(srv.tick(np.asarray(st)), jsrv.tick(jnp.asarray(st)))
        check_snapshot(srv, jsrv)
    assert srv._auto_stamp == pytest.approx(0.15)


def test_level_two_keeps_lane_like_jax(net):
    jsrv, srv = servers(net, "mpdm", autonomous_level=2)
    for st in (SLOW_LEADER, CROSSING[1]):
        dec = srv.tick(np.asarray(st))
        check_tick(dec, jsrv.tick(jnp.asarray(st)))
        assert dec.behavior == mpdm.LK
        assert dec.forward_traj.shape == (11, 2, 6)


def test_mpdm_hmi_lock_matches_jax(net):
    """MPDM picks LCL; the lock to LK holds (valid), the lock to LCR does
    not (no right lane), and a released lock returns the planner's
    choice."""
    jsrv, srv = servers(net, "mpdm")
    got = []
    for lock in (None, mpdm.LK, mpdm.LCR, None):
        srv.lock_to_hmi(lock)
        jsrv.lock_to_hmi(lock)
        dec = srv.tick(np.asarray(SLOW_LEADER))
        check_tick(dec, jsrv.tick(jnp.asarray(SLOW_LEADER)))
        got.append(dec.behavior)
    assert got == [mpdm.LCL, mpdm.LK, mpdm.LCL, mpdm.LCL]

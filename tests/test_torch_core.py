"""The port's copied core modules equal the JAX package's: enum index
orders and values, integer constants, encodings, config checks, layouts and
mission spaces."""

import enum

import numpy as np
import pytest

import multigrid_tpu.core.actions as jax_actions
import multigrid_tpu.core.config as jax_config
import multigrid_tpu.core.constants as jax_constants
import multigrid_tpu.core.mission as jax_mission
import multigrid_tpu.envs.layout as jax_layout
import multigrid_tpu_torch.core.actions as actions
import multigrid_tpu_torch.core.config as config
import multigrid_tpu_torch.core.constants as constants
import multigrid_tpu_torch.core.mission as mission
import multigrid_tpu_torch.envs.layout as layout


@pytest.mark.parametrize('name', ['Type', 'Color', 'State', 'Direction'])
def test_enum_orders_and_values(name):
    ours, theirs = getattr(constants, name), getattr(jax_constants, name)
    assert [(m.name, m.value) for m in ours] == [(m.name, m.value) for m in theirs]
    if issubclass(ours, enum.IntEnum):
        assert [int(m) for m in ours] == [int(m) for m in theirs]
    else:
        assert [m.to_index() for m in ours] == [m.to_index() for m in theirs]
        np.testing.assert_array_equal(
            ours.from_index(np.arange(len(ours))),
            theirs.from_index(np.arange(len(theirs))))


def test_actions():
    assert [(a.name, int(a)) for a in actions.Action] == \
        [(a.name, int(a)) for a in jax_actions.Action]
    assert actions.NUM_ACTIONS == jax_actions.NUM_ACTIONS


def test_integer_constants_and_encodings():
    names = [k for k in vars(jax_constants)
             if k.isupper() and k.split('_')[0] in
             ('TYPE', 'COLOR', 'STATE', 'DIR', 'NUM', 'EMPTY', 'WALL', 'UNSEEN',
              'TILE')]
    assert len(names) > 25
    for k in names:
        np.testing.assert_array_equal(getattr(constants, k),
                                      getattr(jax_constants, k), err_msg=k)
    np.testing.assert_array_equal(constants.DIR_TO_VEC, jax_constants.DIR_TO_VEC)
    for table in ('OBJECT_TO_IDX', 'COLOR_TO_IDX', 'STATE_TO_IDX'):
        assert {k.value: v for k, v in getattr(constants, table).items()} == \
            {k.value: v for k, v in getattr(jax_constants, table).items()}
    for c in constants.COLORS:
        np.testing.assert_array_equal(constants.COLORS[c], jax_constants.COLORS[c])


def test_config_checks():
    kw = dict(width=8, height=8, num_agents=3, max_steps=50)
    assert config.EnvConfig(**kw) == config.EnvConfig(**kw)
    assert [f.name for f in config.dataclasses.fields(config.EnvConfig)] == \
        [f.name for f in jax_config.dataclasses.fields(jax_config.EnvConfig)]
    for bad in (dict(view_size=6), dict(view_size=1), dict(width=2)):
        with pytest.raises(AssertionError):
            config.EnvConfig(**{**kw, **bad})


def test_layout_builders():
    for name in ('WALL', 'GOAL', 'LAVA', 'EMPTY'):
        np.testing.assert_array_equal(getattr(layout, name), getattr(jax_layout, name))
    ours, theirs = layout.empty_grid(7, 5), jax_layout.empty_grid(7, 5)
    layout.wall_rect(ours, 0, 0, 7, 5)
    jax_layout.wall_rect(theirs, 0, 0, 7, 5)
    ours[3, 2] = layout.door(2, 1)
    theirs[3, 2] = jax_layout.door(2, 1)
    np.testing.assert_array_equal(ours, theirs)


def test_mission_space():
    def fn(c, o):
        return f'pick up the {c} {o}'
    ph = [['red', 'blue'], ['ball', 'key']]
    ours = mission.MissionSpace(fn, ph, seed=0)
    theirs = jax_mission.MissionSpace(fn, ph, seed=0)
    assert [str(m) for m in ours] == [str(m) for m in theirs]
    assert ours.get('blue', 'key').index == theirs.get('blue', 'key').index
    assert str(ours.sample()) == str(theirs.sample())

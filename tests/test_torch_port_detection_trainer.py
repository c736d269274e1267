"""One `DetectionTrainer` step and `evaluate` (val losses, voxnocs, COCO
AP) against the JAX package's `DetectionTrainer` at the tiny config with
open gates, on the CPU, on the tiny fixture of test_torch_port_workflow.py.

Both sides compute in float64 (JAX under `jax.enable_x64`, the port's
detector after `.double()`; see test_torch_port_detector.py); the JAX
trainer state is carried into the port by
`importers/flax_params.py:import_train_state`, and the sampler and RANSAC
draws are rebuilt from JAX's keys under x64 (whose uniforms and integers
differ from the float32 draws).  The JAX side is compiled once, in a
module fixture.

Tolerances.  The flax detector heads cast their outputs to float32 even
under x64, so losses agree to rtol 1e-5, the evaluation metrics to 1e-4
and the Adam moments to 2e-5 of each leaf's scale.  Adam's first update is
+-lr times g / (|g| + eps), so an element whose gradient is within float32
rounding of 0 may move by up to lr in one package and not the other:
updated parameters agree to atol 2 lr (ROADMAP.md Queue 3, "Adam's first
step").
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mot3d_tpu.models import mask_rcnn as mrcnn_j
from mot3d_tpu.train import detection_trainer as det_trainer_j
from mot3d_tpu_torch.data.detection_loader import (iterate_detection_batches,
                                                   load_frame, stack_samples)
from mot3d_tpu_torch.data.motfront import MOTFrontDataset
from mot3d_tpu_torch.importers.flax_params import (import_train_state,
                                                   mask_rcnn_state_dict)
from mot3d_tpu_torch.models.mask_rcnn import DetectionDraws
from mot3d_tpu_torch.train.detection_trainer import DetectionTrainer
from test_torch_port_workflow import (_close, _jax_keys, _tiny,
                                      root)  # noqa: F401 (a fixture)
from torch_port_helpers import port_config, random_params, slot_draws

torch.set_num_threads(1)

f64 = functools.partial(jax.tree_util.tree_map,
                        lambda a: np.asarray(a, np.float64))


def _open_gates(cfg):
    """Every gate open and the detector's score gate too, so the
    random-weight detector's slots reach the pose stage."""
    return cfg.replace(
        detection=dataclasses.replace(cfg.detection, score_thresh_test=-1.0),
        combined=dataclasses.replace(cfg.combined, objectness_thres=-1.0,
                                     iou2d_thres=-1.0),
        pose=dataclasses.replace(cfg.pose, min_inlier_ratio=0.0))


def _det_weights(cfg):
    """Random flax detector params; the mask predictor sharpened (mask
    probabilities away from the 0.5 threshold) and the NOCS head constant
    (well-posed Umeyama centroids), as test_torch_port_train.py does."""
    det = cfg.detection
    img = jnp.zeros((1, det.pad_height, det.pad_width, 3))
    params = random_params(mrcnn_j.MaskRCNN(det), img, seed=0,
                           method=mrcnn_j.MaskRCNN.predict)
    params["params"]["mask_head"]["Conv_4"]["kernel"] *= 5.0
    params["params"]["nocs_head"]["ConvTranspose_3"]["kernel"] *= 0.0
    return params


def _det_draws(key, b, n_anchors, n_rois):
    """The sampler uniforms JAX's `train_losses` draws from `key` under
    x64 (float64 uniforms: their values differ from float32 draws)."""
    with jax.enable_x64(True):
        keys = jax.random.split(key, 2 * b)
        return DetectionDraws(
            torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
                k, (n_anchors,))) for k in keys[:b]])),
            torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
                k, (n_rois,))) for k in keys[b:]])))


@pytest.fixture(scope="module")
def jax_detection(root, tmp_path_factory):
    """JAX's DetectionTrainer at the tiny config with open gates: evaluate
    (losses, voxnocs, AP) on the val split, then one train step."""
    cfg = _open_gates(_tiny())
    val = list(iterate_detection_batches(MOTFrontDataset(root, "val"),
                                         port_config(cfg).detection, 3,
                                         shuffle=False))
    train = stack_samples([load_frame(MOTFrontDataset(root, "train"), fr,
                                      port_config(cfg).detection)
                           for fr in MOTFrontDataset(root, "train")
                           .load_scene("scene_1_0000").frames[:2]])
    params = _det_weights(cfg)
    key = jax.random.PRNGKey(9)
    with jax.enable_x64(True):
        tr = det_trainer_j.DetectionTrainer(
            cfg, str(tmp_path_factory.mktemp("jax_detection")))
        p64 = f64(params)
        tr.state = det_trainer_j.DetectionTrainState(
            p64, tr.optimizer.init(p64), jnp.zeros((), jnp.int32))
        evaluated = tr.evaluate(val, voxnocs=True, ap=True)
        state, losses = tr._make_step()(
            tr.state, jnp.asarray(train.image),
            det_trainer_j.sample_to_gt(train), key)
        state = jax.device_get(state)
        losses = {k: float(v) for k, v in losses.items()}
        init_state = jax.device_get(tr.optimizer.init(p64))
    return dict(cfg=cfg, val=val, train=train, params=params, key=key,
                evaluated=evaluated, state=state, losses=losses,
                opt0=init_state)


def _port_detection_trainer(j, out_dir):
    cfg_t = port_config(j["cfg"])
    tr = DetectionTrainer(cfg_t, str(out_dir), device="cpu")
    tr.model.double()
    tr.init_state()
    import_train_state((j["params"], j["opt0"], 0), tr.state)
    return tr


def test_detection_evaluate_matches_jax(jax_detection, tmp_path):
    """Validation losses, the voxnocs metrics (through the exporter, K1's
    plain version) and COCO bbox/segm AP from one shared prediction pass,
    with JAX's evaluation keys; non-vacuous (poses are fitted)."""
    j = jax_detection
    tr = _port_detection_trainer(j, tmp_path)
    det = j["cfg"].detection
    n_rois = tr.model.num_proposals_train() + det.max_instances
    rng = jax.random.PRNGKey(0)
    loss_draws = []
    for _ in j["val"]:
        rng, sub = jax.random.split(rng)
        loss_draws.append(_det_draws(sub, 3, tr.model.anchors.shape[0],
                                     n_rois))
    tr.eval_draws = lambda i, b: loss_draws[i]
    p = j["cfg"].pose
    frames = sum(len(b.image) for b in j["val"])
    with jax.enable_x64(True):     # int64 randint under x64, as JAX drew
        ransac = [torch.from_numpy(slot_draws(k, det.detections_per_image,
                                              p.ransac_iters,
                                              p.ransac_sample_size))
                  for k in _jax_keys(frames)]
    ex = tr.exporter()
    evaluate_samples = ex.evaluate_samples
    ex.evaluate_samples = lambda s, **kw: evaluate_samples(
        s, draws_list=ransac, **kw)
    got = tr.evaluate(j["val"], voxnocs=True, ap=True)
    want = j["evaluated"]
    assert sorted(got) == sorted(want)
    assert any(k.endswith("/rot_err_median") for k in got)
    for k, v in want.items():
        tol = 1e-5 if k.startswith("val_") else 1e-4
        assert got[k] == pytest.approx(v, rel=tol, abs=tol), k


def test_detection_step_matches_jax(jax_detection, tmp_path):
    """One DetectionTrainer update from the carried-over JAX state: equal
    loss dict, Adam moments and count, parameters within the first-step
    bound; then the step counter and the schedule position move on."""
    j = jax_detection
    tr = _port_detection_trainer(j, tmp_path)
    train = j["train"]
    draws = _det_draws(j["key"], 2, tr.model.anchors.shape[0],
                       tr.model.num_proposals_train()
                       + j["cfg"].detection.max_instances)
    losses = tr.train_step(train, draws)
    assert sorted(losses) == sorted(j["losses"])
    for k, v in j["losses"].items():
        assert float(losses[k]) == pytest.approx(v, rel=1e-5, abs=1e-7), k
    assert tr.state.step == 1 and tr.state.scheduler.last_epoch == 1
    adam = j["state"].opt_state[0]
    mu = mask_rcnn_state_dict(adam.mu, port_config(j["cfg"]))
    lr = j["cfg"].combined.detection_lr
    want = mask_rcnn_state_dict(j["state"].params, port_config(j["cfg"]))
    opt = tr.state.optimizer.state_dict()["state"]
    for i, (name, p) in enumerate(tr.model.named_parameters()):
        scale = max(float(np.abs(mu[name].numpy()).max()), 1e-12)
        _close(opt[i]["exp_avg"], mu[name], rtol=0, atol=2e-5 * scale,
               what=name)
        _close(p.detach(), want[name], rtol=0, atol=2 * lr, what=name)
    assert int(opt[0]["step"]) == int(adam.count) == 1

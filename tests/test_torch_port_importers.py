"""The port's torch-checkpoint importer and exporter against the JAX
package's, on the CPU.

Detectron2 dictionaries come from the JAX package's
`export_detectron2_maskrcnn` of random full-width JAX params (the importer
accepts only the reference widths; the params are filled with numpy,
nothing is compiled).  Every comparison is exact: an
import only renames, permutes and folds float32 numpy arrays, the same
operations in both packages.  The tracking dictionaries are built from the
key names the reference's modules save (`Tracking/networks/*.py`), with
the MLPs' Linear layers at the indices a Sequential with activations and
dropout gives them.  TrackerModel logits: rtol = atol = 1e-5 in float32 on
a tiny graph, time-aware message passing included.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mot3d_tpu.config import Config as ConfigJ
from mot3d_tpu.config import DetectionConfig, GraphConfig, TrackingConfig
from mot3d_tpu.importers import torch_ckpt as ckpt_j
from mot3d_tpu.importers import torch_export as export_j
from mot3d_tpu.models.mpn import TrackerModel as TrackerJ
from mot3d_tpu_torch import cli
from mot3d_tpu_torch.importers import torch_ckpt, torch_export
from mot3d_tpu_torch.importers.flax_params import (mask_rcnn_state_dict,
                                                   tracker_state_dict)
from mot3d_tpu_torch.models.mask_rcnn import MaskRCNN
from mot3d_tpu_torch.models.mpn import TrackerModel
from torch_port_helpers import port_config, randomise_affine

torch.set_num_threads(1)


def _jax_params(det: DetectionConfig, seed: int, like=None):
    """Random JAX params of the full-width import-mode detector `det`.  The
    tree is JAX's import of the port's export of a fresh port model (the
    JAX importer's tree is the model's own, tests/test_torch_import.py);
    tracing the whole JAX model for its shapes would cost seconds.  Every
    leaf then takes numpy values: kernels N(0, 1/fan_in), biases N(0,
    0.01), affines non-trivial, the voxel decoder's biases 0 (the
    reference's decoder is bias-free: its export carries none).  With
    `like`, every section but the NOCS head is taken from it."""
    cfg_t = _port_cfg(det)
    tree = ckpt_j.import_detectron2_maskrcnn(
        torch_export.export_detectron2_maskrcnn(
            MaskRCNN(cfg_t.detection, device="cpu").state_dict(),
            cfg_t.detection), det)
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "bias":
            return rng.normal(0, 0.01, leaf.shape).astype(np.float32)
        return (rng.standard_normal(leaf.shape, dtype=np.float32)
                / np.float32(np.sqrt(np.prod(leaf.shape[:-1]))))

    if like is not None:
        tree = {"params": {"nocs_head": tree["params"]["nocs_head"]}}
    params = randomise_affine(jax.tree_util.tree_map_with_path(fill, tree),
                              rng)
    if like is not None:
        return {"params": {**like["params"], **params["params"]}}
    for layer in params["params"]["voxel_head"].values():
        if "kernel" in layer:
            layer["bias"] = np.zeros_like(layer["bias"])
    return params


@pytest.fixture(scope="module")
def detectors():
    """mode -> (JAX config, random JAX params, the detectron2 dict JAX
    exports from them), for the regression NOCS head and the bin head; the
    import config at full reference widths on 64 x 64 frames."""
    det = dataclasses.replace(
        ckpt_j.import_config(DetectionConfig()), pad_height=64, pad_width=64,
        image_height=64, image_width=64)
    bins = dataclasses.replace(det, nocs_use_bin_loss=True)
    params = _jax_params(det, 0)
    params_b = _jax_params(bins, 1, like=params)
    return {mode: (c, p, export_j.export_detectron2_maskrcnn(p, c))
            for mode, c, p in (("nocs", det, params),
                               ("bins", bins, params_b))}


def _port_cfg(det):
    return port_config(ConfigJ(detection=det))


def _assert_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.parametrize("mode", ["nocs", "bins"])
def test_detectron2_import_matches_jax(detectors, mode):
    """The port's import of JAX's export equals `flax_params` of JAX's
    import of it, tensor for tensor; the port's export of it gives JAX's
    dict back exactly."""
    det, params, d2 = detectors[mode]
    cfg_t = _port_cfg(det)
    got = torch_ckpt.import_detectron2_maskrcnn(d2, cfg_t.detection)
    want = mask_rcnn_state_dict(
        ckpt_j.import_detectron2_maskrcnn(d2, det), cfg_t)
    _assert_equal(got, want)
    again = torch_export.export_detectron2_maskrcnn(got, cfg_t.detection)
    assert sorted(again) == sorted(d2)
    for k, v in d2.items():
        np.testing.assert_array_equal(again[k], v, err_msg=k)


def test_detectron2_export_round_trips_through_jax_and_disk(detectors,
                                                           tmp_path):
    """The port's export -> JAX's import gives the JAX params back exactly;
    a .pth in detectron2's envelope loads back to the same import."""
    det, params, d2 = detectors["nocs"]
    cfg_t = _port_cfg(det)
    sd = mask_rcnn_state_dict(params, cfg_t)
    mine = torch_export.export_detectron2_maskrcnn(sd, cfg_t.detection)
    back = dict(jax.tree_util.tree_leaves_with_path(
        ckpt_j.import_detectron2_maskrcnn(mine, det)))
    want = jax.tree_util.tree_leaves_with_path(params)
    assert len(back) == len(want)
    for path, v in want:
        np.testing.assert_array_equal(back[path], v, err_msg=str(path))
    path = str(tmp_path / "model.pth")
    torch_export.save_torch_state_dict(path, mine)
    loaded = torch_ckpt.load_torch_state_dict(path)
    assert sorted(loaded) == sorted(d2)
    _assert_equal(torch_ckpt.import_detectron2_maskrcnn(
        loaded, cfg_t.detection), sd)


def test_strict_and_partial_detector_import(detectors):
    """Strict mode refuses an unknown key, a missing key and a missing
    section; a partial import keeps the fresh init for the sections the
    checkpoint lacks (a COCO-zoo-like backbone + RPN + box + mask dict),
    as JAX's does with its init params."""
    det, params, d2 = detectors["nocs"]
    cfg_t = _port_cfg(det)
    with pytest.raises(KeyError, match="unconsumed"):
        torch_ckpt.import_detectron2_maskrcnn(
            {**d2, "roi_heads.mystery.weight": np.zeros(3, np.float32)},
            cfg_t.detection)
    missing = dict(d2)
    del missing["backbone.fpn_output3.bias"]
    with pytest.raises(KeyError, match="fpn_output3.bias"):
        torch_ckpt.import_detectron2_maskrcnn(missing, cfg_t.detection)
    zoo = {k: v for k, v in d2.items()
           if not k.startswith(("roi_heads.voxel_head", "roi_heads.nocs_head"))}
    with pytest.raises(KeyError, match="voxel_head"):
        torch_ckpt.import_detectron2_maskrcnn(zoo, cfg_t.detection)
    init = MaskRCNN(cfg_t.detection, device="cpu").state_dict()
    got = torch_ckpt.import_detectron2_maskrcnn(
        {**zoo, "pixel_mean": np.zeros(3, np.float32)}, cfg_t.detection,
        init_state_dict=init, strict=False)
    want_j = ckpt_j.import_detectron2_maskrcnn(
        zoo, det, init_params=params, strict=False)
    fresh = ("voxel_head.", "nocs_head.")
    _assert_equal(got, {**{k: v for k, v in mask_rcnn_state_dict(
        want_j, cfg_t).items() if not k.startswith(fresh)},
        **{k: v for k, v in init.items() if k.startswith(fresh)}})


# ------------------------------------------------------------- tracking


def _linear(rng, sd, prefix, o, i):
    sd[f"{prefix}.weight"] = rng.normal(0, 1 / np.sqrt(i), (o, i)).astype(
        np.float32)
    sd[f"{prefix}.bias"] = rng.normal(0, 0.1, o).astype(np.float32)


def _mlp(rng, sd, prefix, in_dim, dims, step):
    """A reference MLP: Linear layers at indices 0, step, 2 step, ...
    (Linear, activation[, dropout]) with no activation after a 1-wide
    layer."""
    for n, o in enumerate(dims):
        _linear(rng, sd, f"{prefix}.layers.{n * step}", o, in_dim)
        in_dim = o


def tracking_dicts(g: GraphConfig, seed: int = 0):
    """The reference's (voxel_encoder, graph_net, edge_classifier)
    state_dicts for GraphConfig g."""
    rng = np.random.default_rng(seed)
    venc: dict = {}
    chans = (1, 8, 16, 32, 32)
    for n, name in enumerate(("conv_in", "conv_0", "conv_1", "conv_2")):
        i, o = chans[n], chans[n + 1]
        venc[f"{name}.weight"] = rng.normal(
            0, 1 / np.sqrt(27 * i), (o, i, 3, 3, 3)).astype(np.float32)
        venc[f"{name}.bias"] = rng.normal(0, 0.1, o).astype(np.float32)
    _linear(rng, venc, "fc", 256, 32 * 4 * 4 * 4)
    _linear(rng, venc, "fc2", g.node_dim, 256)
    gnet: dict = {}
    e, h = g.edge_out_dim, g.node_dim
    h_in = 2 * h if g.reattach_initial_nodes else h
    e_in = 2 * e if g.reattach_initial_edges else e
    msg = g.edge_model_fc_dims[-1]
    _mlp(rng, gnet, "encoder.edge_mlp", g.edge_in_dim,
         tuple(g.edge_fc_dims) + (e,), 2)
    _mlp(rng, gnet, "MPNet.edge_model.edge_mlp", 2 * h_in + e_in,
         g.edge_model_fc_dims, 3)
    node = g.node_model_fc_dims
    if g.time_aware_mp:
        _mlp(rng, gnet, "MPNet.node_model.flow_in_mlp", h_in + msg, node, 2)
        _mlp(rng, gnet, "MPNet.node_model.flow_out_mlp", h_in + msg, node, 3)
        _mlp(rng, gnet, "MPNet.node_model.node_mlp", 2 * node[-1], node, 2)
    else:
        _mlp(rng, gnet, "MPNet.node_model.node_mlp", h + msg, node, 2)
    eclf: dict = {}
    _linear(rng, eclf, "fc1", g.classifier_intermed_dim, msg)
    _linear(rng, eclf, "fc2", 1, g.classifier_intermed_dim)
    return venc, gnet, eclf


def _graph(n_nodes=6, e=24, seed=1):
    rng = np.random.default_rng(seed)
    vox = (rng.uniform(size=(n_nodes, 32, 32, 32)) < 0.3).astype(np.float32)
    src = rng.integers(0, n_nodes, e).astype(np.int32)
    dst = rng.integers(0, n_nodes, e).astype(np.int32)
    attr = rng.normal(size=(e, 8)).astype(np.float32)
    mask = rng.uniform(size=e) > 0.2
    return vox, src, dst, attr, mask


@pytest.mark.parametrize("time_aware", [False, True])
def test_tracking_import_matches_jax(time_aware):
    """Import exactly equal to `flax_params` of JAX's import; the logits of
    the port's TrackerModel with it equal JAX's TrackerModel with JAX's
    import to 1e-5; export gives the dictionaries back exactly."""
    g = GraphConfig(time_aware_mp=time_aware)
    cfg_t = port_config(ConfigJ(graph=g))
    dicts = tracking_dicts(g, seed=int(time_aware))
    got = torch_ckpt.import_tracking_modules(*dicts, cfg_t.graph)
    params = ckpt_j.import_tracking_modules(*dicts, g)
    _assert_equal(got, tracker_state_dict(params, cfg_t))
    for mine, want in zip(torch_export.export_tracking_modules(
            got, cfg_t.graph), dicts):
        renum = {}
        for prefix in {k.rsplit(".layers.", 1)[0] for k in want
                       if ".layers." in k}:
            idx = sorted({int(k.split(".")[-2]) for k in want
                          if k.startswith(prefix + ".layers.")})
            renum.update({f"{prefix}.layers.{j}": f"{prefix}.layers.{2 * n}"
                          for n, j in enumerate(idx)})
        want = {renum.get(k.rsplit(".", 1)[0], k.rsplit(".", 1)[0]) + "."
                + k.rsplit(".", 1)[1]: v for k, v in want.items()}
        assert sorted(mine) == sorted(want)
        for k, v in want.items():
            np.testing.assert_array_equal(mine[k], v, err_msg=k)

    args = _graph()
    logits_j = np.asarray(jax.jit(TrackerJ(g).apply)(
        params, *map(jnp.asarray, args)))
    model = TrackerModel(cfg_t.graph, device="cpu")
    model.load_state_dict(got, strict=True)
    with torch.no_grad():
        logits_t = model(*map(torch.from_numpy, args)).numpy()
    assert logits_t.shape == (g.num_mp_steps - 1, len(args[1]))
    np.testing.assert_allclose(logits_t, logits_j, rtol=1e-5, atol=1e-5)


def test_tracking_import_refuses_unknown_and_missing_keys():
    g = GraphConfig()
    venc, gnet, eclf = tracking_dicts(g)
    with pytest.raises(KeyError, match="unconsumed voxel_encoder"):
        torch_ckpt.import_tracking_modules(
            {**venc, "mystery.weight": np.zeros(3)}, gnet, eclf, g)
    with pytest.raises(KeyError, match="edge_classifier is missing"):
        torch_ckpt.import_tracking_modules(
            venc, gnet, {k: v for k, v in eclf.items() if k != "fc2.bias"},
            g)
    # A time-aware config needs the flow MLPs.
    with pytest.raises(KeyError):
        torch_ckpt.import_tracking_modules(
            venc, gnet, eclf, dataclasses.replace(g, time_aware_mp=True))


def test_cli_imports_then_infers_with_export_vis(tmp_path, capsys):
    """import-torch-ckpt of the three tracking files (time-aware), then
    infer-tracking --ckpt --export-vis on .h5 sequences, in process on the
    CPU: the restored weights are the imported ones, and every sequence
    gets its replay page and trajectory PLYs (the classifier's bias makes
    every edge positive, so trajectories form)."""
    from mot3d_tpu.data.synthetic import synthetic_sequence
    from mot3d_tpu_torch.data.h5_io import FrameDetections, write_frame_h5
    from mot3d_tpu_torch.train.tracking_trainer import TrackingTrainer

    g = GraphConfig(time_aware_mp=True)
    dicts = tracking_dicts(g, seed=2)
    dicts[2]["fc2.bias"][:] = 20.0      # every edge positive: tracks form
    paths = []
    for name, sd in zip(("voxel_encoder", "graph_net", "edge_classifier"),
                        dicts):
        paths.append(str(tmp_path / f"{name}.pth"))
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   paths[-1])
    ov = ["graph.time_aware_mp=true", "tracking.seq_len=3",
          "tracking.max_instances_per_frame=4"]
    out = str(tmp_path / "imported")
    cli.main(["import-torch-ckpt", "--voxel-encoder", paths[0],
              "--graph-net", paths[1], "--edge-classifier", paths[2],
              "--out", out, "--device", "cpu", *ov])
    want = torch_ckpt.import_tracking_modules(
        *map(torch_ckpt.load_torch_state_dict, paths),
        port_config(ConfigJ(graph=g)).graph)
    cfg_t = cli.apply_overrides(cli.default_config(), ov)
    tt = TrackingTrainer(cfg_t, str(tmp_path / "t"), device="cpu")
    tt.init_state()
    cli._restore_or_die(tt, out, "mota")
    _assert_equal(tt.model.state_dict(), want)
    with pytest.raises(SystemExit, match="all three"):
        cli.main(["import-torch-ckpt", "--graph-net", paths[1], "--out",
                  out, "--device", "cpu"])

    data = tmp_path / "h5"
    for s in range(2):
        seq = synthetic_sequence(TrackingConfig(
            seq_len=3, max_instances_per_frame=4), seed=s, num_objects=3)
        for t in range(3):
            d, gv = seq.det_valid[t], seq.gt_valid[t]
            write_frame_h5(str(data / f"scene_{s:04d}" / f"{t}.h5"),
                           FrameDetections(
                               classes=seq.classes[t][d],
                               objectness_scores=np.ones(d.sum(), np.float32),
                               voxels=seq.voxels[t][d],
                               rotations=seq.rotations[t][d],
                               translations=seq.translations[t][d],
                               scales=seq.scales[t][d],
                               pred_boxes=seq.pred_boxes[t][d],
                               gt_ids=seq.gt_ids[t][gv],
                               gt_boxes=seq.gt_boxes[t][gv],
                               gt_voxels=np.zeros((gv.sum(), 32, 32, 32)),
                               gt_rotations=seq.gt_rotations[t][gv],
                               gt_locations=seq.gt_locations[t][gv],
                               gt_scales=seq.gt_scales[t][gv],
                               gt_compl_boxes=seq.gt_boxes[t][gv],
                               gt_classes=seq.gt_classes[t][gv]))
    capsys.readouterr()
    cli.main(["infer-tracking", "--data", str(data), "--ckpt", out, "--out",
              str(tmp_path / "ev"), "--export-vis", "--device", "cpu", *ov])
    assert "mota:" in capsys.readouterr().out
    for s in range(2):
        vis = tmp_path / "ev" / "vis" / f"seq_{s:03d}"
        assert (vis / "replay.html").stat().st_size > 1000
        assert list(vis.glob("traj_*.ply"))

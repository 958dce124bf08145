"""The inputs made from the seed: the same seed gives the same tensors, the region
labels come in contiguous regions with their ignore share, and the stage geometry is
the network's."""

import torch
import torch.nn.functional as F

from benchmark import inputs
from benchmark.reference import network


def test_region_labels_have_their_ignore_share_and_are_not_iid():
    g = inputs.generator(2 ** 33 + 7, "t", "cpu")
    lab = inputs.region_labels(g, 2, (128, 256), 19, 16, 0.1, "cpu")
    assert lab.dtype == torch.uint8 and lab.shape == (2, 128, 256)
    share = (lab == 255).float().mean().item()
    assert abs(share - 0.1) < 0.005
    known = lab[lab != 255]
    assert int(known.max()) < 19 and len(torch.unique(known)) > 5
    # Neighbours agree far more often than iid labels' 1/19.
    agree = (lab[:, :, 1:] == lab[:, :, :-1]).float().mean().item()
    assert agree > 0.8


def test_the_same_seed_gives_the_same_inputs_and_another_seed_others():
    mix = {"batch": 2, "hw": [32, 64], "pool": 2, "labels": {"stride": 8,
                                                              "ignore_share": 0.1}}
    a, b = (inputs.train_pool(5, mix, 19, "cpu") for _ in range(2))
    c = inputs.train_pool(6, mix, 19, "cpu")
    for x, y, z in zip(a, b, c):
        assert torch.equal(x["image"], y["image"]) and torch.equal(x["label"], y["label"])
        assert not torch.equal(x["image"], z["image"])
    assert not torch.equal(a[0]["image"], a[1]["image"])  # the pool's rows differ
    model = {"num_classes": 19, "open_classes": 15, "layers": [1, 1, 1, 1]}
    w1 = inputs.model_weights(5, "student", model, "cpu", True)
    w2 = inputs.model_weights(5, "student", model, "cpu", True)
    assert all(torch.equal(w1[k], w2[k]) for k in w1)
    assert abs(w1["layer3.0.conv2.weight"].std().item() - inputs.INIT_STD) < 1e-3


def test_stage_geometry_is_the_networks():
    for hw in ((512, 1024), (640, 1280), (64, 128), (65, 97)):
        x = torch.zeros(1, 64, (hw[0] - 1) // 2 + 1, (hw[1] - 1) // 2 + 1)
        pooled = F.max_pool2d(x, 3, 2, 1, ceil_mode=True).shape[2:]
        geo = inputs.stage_geometry(hw, [1, 1, 1, 1])
        assert geo[0] == tuple(pooled)
        l2 = F.conv2d(torch.zeros(1, 1, *pooled), torch.zeros(1, 1, 1, 1), stride=2)
        assert geo[1] == geo[2] == geo[3] == tuple(l2.shape[2:])
    assert inputs.stage_geometry((512, 1024), [3, 4, 23, 3])[-1] == (65, 129)
    assert network.param_spec(19, 15, True, [3, 4, 23, 3])[0][0] == "conv1.weight"

"""The paper's own workloads: all stride>=2 conv layers of the evaluated CNNs.

PyTorch-package copy of ``repro.configs.paper_cnn`` (the port imports
nothing of the JAX package).  Layer tuples are (H_i, C, N, K, S, P)
following Table II's ``H_i(W_i)/C/N/K_h(K_w)/S/P_h(P_w)`` notation.
Batch size 2 and FP32, matching Section IV's setup.
"""

from __future__ import annotations

from repro_torch.core.im2col_ref import ConvDims

BATCH = 2  # paper Section IV

TABLE2_LAYERS = [
    # (H_i, C, N, K, S, P)        # paper Table II rows
    (224, 3, 64, 3, 2, 0),
    (112, 64, 64, 3, 2, 1),
    (56, 256, 512, 1, 2, 0),
    (28, 244, 244, 3, 2, 1),
    (14, 1024, 2048, 1, 2, 0),
]

# stride>=2 convolutional layers per network (kernel-bearing, from the
# published architectures).
NETWORKS: dict[str, list[tuple[int, int, int, int, int, int]]] = {
    "alexnet": [
        (224, 3, 64, 11, 4, 2),
    ],
    "densenet": [
        (224, 3, 64, 7, 2, 3),
    ],
    "mobilenet": [
        (224, 3, 32, 3, 2, 1),
        (112, 32, 32, 3, 2, 1),
        (56, 64, 64, 3, 2, 1),
        (28, 128, 128, 3, 2, 1),
        (14, 256, 256, 3, 2, 1),
    ],
    "resnet": [
        (224, 3, 64, 7, 2, 3),
        (56, 256, 512, 1, 2, 0),
        (28, 512, 1024, 1, 2, 0),
        (14, 1024, 2048, 1, 2, 0),
        (56, 128, 128, 3, 2, 1),
        (28, 256, 256, 3, 2, 1),
        (14, 512, 512, 3, 2, 1),
    ],
    "shufflenet": [
        (224, 3, 24, 3, 2, 1),
        (56, 24, 24, 3, 2, 1),
        (28, 116, 116, 3, 2, 1),
        (14, 232, 232, 3, 2, 1),
    ],
    "squeezenet": [
        (224, 3, 96, 7, 2, 0),
    ],
}


def dims(layer: tuple[int, int, int, int, int, int],
         batch: int = BATCH) -> ConvDims:
    h, c, n, k, s, p = layer
    return ConvDims(B=batch, C=c, H_i=h, W_i=h, N=n, K_h=k, K_w=k,
                    S=s, P_h=p, P_w=p)


def table2_dims(batch: int = BATCH) -> list[ConvDims]:
    return [dims(layer, batch) for layer in TABLE2_LAYERS]

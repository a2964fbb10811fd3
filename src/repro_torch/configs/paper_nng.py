"""The paper's own workloads: ε-NNG construction configs (Table I scale)."""
from dataclasses import dataclass


@dataclass(frozen=True)
class NNGConfig:
    name: str
    n: int
    dim: int
    metric: str
    eps: float
    algorithm: str = "landmark"   # systolic | landmark
    k_cap: int = 128
    m_centers: int | None = None


NNG_CONFIGS = {
    # sift-scale: 1M x 128d euclidean (the paper's largest Euclidean run)
    "nng-sift-1m": NNGConfig("nng-sift-1m", n=1 << 20, dim=128,
                             metric="euclidean", eps=175.0),
    # word2bits-scale hamming: 400k x 800 bits (25 uint32 words)
    "nng-word2bits": NNGConfig("nng-word2bits", n=399360, dim=25,
                               metric="hamming", eps=250.0),
    # synthetic 16M point cloud (beyond-paper scale)
    "nng-synth-16m": NNGConfig("nng-synth-16m", n=1 << 24, dim=64,
                               metric="euclidean", eps=1.0),
}

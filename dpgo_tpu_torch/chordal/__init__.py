from dpgo_tpu_torch.chordal.dchordal import (DChordalConfig,
                                             distributed_chordal_init)

__all__ = ["DChordalConfig", "distributed_chordal_init"]

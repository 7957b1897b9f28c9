from .decoder import DecoderMode, DecoderOutput, TacotronDecoder
from .tacotron import (Batch, TacotronModel, TacotronOutput, compute_loss,
                       tacotron_model_factory)

__all__ = ["DecoderMode", "DecoderOutput", "TacotronDecoder", "Batch", "TacotronModel",
           "TacotronOutput", "compute_loss", "tacotron_model_factory"]

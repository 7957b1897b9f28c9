from .decoder import DecoderOutput, TacotronDecoder
from .tacotron import (Batch, TacotronModel, TacotronOutput, compute_loss,
                       tacotron_model_factory)

__all__ = ["DecoderOutput", "TacotronDecoder", "Batch", "TacotronModel",
           "TacotronOutput", "compute_loss", "tacotron_model_factory"]

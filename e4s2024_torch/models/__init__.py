"""Networks of the port, with the original reference's state-dict names."""

from e4s2024_torch.models.vgg import StyleGramLoss, VGG16Features, gram_matrix

__all__ = ["StyleGramLoss", "VGG16Features", "gram_matrix"]

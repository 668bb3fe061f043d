from repro_torch.models.model_factory import build_model, Model

"""Pretrained VidLM registry (a copy of ``merv_tpu/models/registry.py``, which the port may not import)."""

# === Pretrained Model Registry ===
# fmt: off
MODEL_REGISTRY = {
    "merv-frozen": {
        "model_id": "merv-frozen",
        "names": ["MERV Frozen"],
        "description": {
            "name": "MERV Frozen",
            "optimization_procedure": "single-stage",
            "visual_representation": "LanguageBind, DINO, SigLIP, ViViT",
            "image_processing": "Letterbox",
            "language_model": "Llama 2 7B",
            "datasets": ["Video-LLaVA"],
            "train_epochs": 1,
        },
    },
    "merv-full": {
        "model_id": "merv-full",
        "names": ["MERV Full"],
        "description": {
            "name": "MERV Full",
            "optimization_procedure": "multi-stage",
            "visual_representation": "LanguageBind, DINO, SigLIP, ViViT",
            "image_processing": "Letterbox",
            "language_model": "Llama 2 7B",
            "datasets": ["Video-LLaVA"],
            "train_epochs": 1,
        },
    },
    "languagebind-single": {
        "model_id": "languagebind-single",
        "names": ["LanguageBind Single Encoder"],
        "description": {
            "name": "LanguageBind Single Encoder",
            "optimization_procedure": "single-stage",
            "visual_representation": "LanguageBind",
            "image_processing": "Letterbox",
            "language_model": "Llama 2 7B",
            "datasets": ["Video-LLaVA"],
            "train_epochs": 1,
        },
    },
    "dinov2-single": {
        "model_id": "dinov2-single",
        "names": ["DINOv2 Single Encoder"],
        "description": {
            "name": "DINOv2 Single Encoder",
            "optimization_procedure": "single-stage",
            "visual_representation": "DINO",
            "image_processing": "Letterbox",
            "language_model": "Llama 2 7B",
            "datasets": ["Video-LLaVA"],
            "train_epochs": 1,
        },
    },
    "vivit-single": {
        "model_id": "vivit-single",
        "names": ["ViViT Single Encoder"],
        "description": {
            "name": "ViViT Single Encoder",
            "optimization_procedure": "single-stage",
            "visual_representation": "ViViT",
            "image_processing": "Letterbox",
            "language_model": "Llama 2 7B",
            "datasets": ["Video-LLaVA"],
            "train_epochs": 1,
        },
    },
    "siglip-single": {
        "model_id": "siglip-single",
        "names": ["SigLIP Single Encoder"],
        "description": {
            "name": "SigLIP Single Encoder",
            "optimization_procedure": "single-stage",
            "visual_representation": "SigLIP",
            "image_processing": "Letterbox",
            "language_model": "Llama 2 7B",
            "datasets": ["Video-LLaVA"],
            "train_epochs": 1,
        },
    },
}
# fmt: on

# Build Global Registry (Model ID, Name) -> Metadata
GLOBAL_REGISTRY = {name: v for k, v in MODEL_REGISTRY.items() for name in [k] + v["names"]}

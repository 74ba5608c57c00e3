"""Model registry (the port's copy of ``climb_tpu/configs/model_configs.py``,
same keys and values)."""

vilt_config = {
    "encoder_dim": 768,
    "visual_input_type": "pil-image",
    "encoder_class": "vilt",
    "batch2inputs_converter": "vilt_single",
    "encoder_name": "ViLT",
}

vilt_lang_seq_config = {
    "encoder_dim": 768,
    "visual_input_type": "pil-image",
    "encoder_class": "vilt",
    "classifier_class": "vilt_seq_classification",
    "batch2inputs_converter": "vilt_seq",
}

vilt_lang_mc_config = {
    "encoder_dim": 768,
    "visual_input_type": "pil-image",
    "encoder_class": "vilt",
    "classifier_class": "vilt_multiple_choice",
    "batch2inputs_converter": "vilt_mc",
}

vilt_vision_cls_config = {
    "encoder_dim": 768,
    "visual_input_type": "pil-image",
    "encoder_class": "vilt",
    "classifier_class": "vilt_image_classification",
    "batch2inputs_converter": "vilt_single",
}

viltbert_config = {
    "encoder_dim": 768,
    "visual_input_type": "pil-image",
    "encoder_class": "viltbert",
    "batch2inputs_converter": "vilt_single",
    "encoder_name": "ViLT-BERT",
}

viltbert_lang_seq_config = {
    "encoder_dim": 768,
    "visual_input_type": "pil-image",
    "encoder_class": "viltbert",
    "classifier_class": "viltbert_seq_classification",
    "batch2inputs_converter": "vilt_seq",
}

viltbert_lang_mc_config = {
    "encoder_dim": 768,
    "visual_input_type": "pil-image",
    "encoder_class": "viltbert",
    "classifier_class": "viltbert_multiple_choice",
    "batch2inputs_converter": "vilt_mc",
}

model_configs = {
    "vilt": vilt_config,
    "vilt-v-cls": vilt_vision_cls_config,
    "vilt-l-seq": vilt_lang_seq_config,
    "vilt-l-mc": vilt_lang_mc_config,
    "viltbert": viltbert_config,
    "viltbert-l-seq": viltbert_lang_seq_config,
    "viltbert-l-mc": viltbert_lang_mc_config,
}

"""The in-the-wild preprocessing's own stages, ported: masks and contours
without cv2 (``masks``), keypoint and silhouette SMPL refinement
(``refine_smpl``), the SMPL overlay check (``visualize_smpl``), the
orchestrator (``process_sequence``) and the LPIPS head extractor
(``extract_lpips_heads``). Each entry point runs as
``python -m instantavatar_torch.preprocess.<name>`` with the flags of its
script under ``scripts/`` plus ``--device cuda|cpu`` (default cuda)."""

"""dataset"""
